"""Audio-visual fusion: frozen encoders, a trained fusion head, paired
extraction.

Counterpart of ``deeplip_tpu/train/fusion.py``. :class:`FusionTrainer`
holds a frozen audio E-TDNN and a frozen video Lipreading network, both in
eval mode (BN running statistics, no dropout), a fusion head (LowFER by
default; LinearFusion or compact bilinear pooling) and a criterion over
the head's output. Clips are batched: the ``(B, G, T, H, W)`` clip tensor
folds to ``(B·G, T, H, W)``, is embedded in one pass, time-averaged per
clip and group-averaged per item under masks.

A train step runs the encoders under ``torch.no_grad()`` (the audio one
on the crop's features with CMVN over the whole crop, the front-end kernel
on the card; the video one through the max-pool kernel), then the head
and the criterion; items without clips (group size 0) are left out of the
loss and the accuracy, and SGD takes one step at the step-indexed
MultiStep rate. Only the head parameters that reach the head's output are
trained: LowFER's ``U``/``V`` (the overwritten MFB branch) and
LinearFusion's ``fc2`` under ``extract_feats`` get no gradient, so they
stay out of the optimizer and never move, as in torch's SGD and the JAX
package's masked chain. ``compute_dtype='bf16'`` runs both encoders in
bf16 and feeds the head bf16-rounded embeddings; the criterion stays f32.

With ``mesh`` (``core.mesh``; one process per card) the head trains
data-parallel: every rank pads the global batch to a multiple of the batch
ranks with zero rows (group size 0, left out of the loss as a bad pair is;
the JAX trainer's mesh padding), keeps its rows, divides its rows' loss by
the all-reduced count of rows with clips, all-reduces the head's and the
criterion's gradients once and reports all-reduced metrics. The head runs
in eval mode, so no statistic crosses the ranks. Rank 0 writes the
checkpoints and the logs.

Test-time extraction is the reference's live path: z-norm(audio x-vector)
++ z-norm(clip-group mean video embedding), the head bypassed;
``use_fusion_head`` returns the head's output instead, and ``return_parts``
the raw pair for score-level fusion.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
from torch import nn

from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.core.mesh import Mesh, all_reduce, local_mesh, replicate
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.video_dataset import load_clip
from deeplip_tpu_torch.eval.scoring import EmbeddingStore
from deeplip_tpu_torch.interop.torch_import import (load_reference_audio_checkpoint,
                                                    load_reference_fusion_checkpoint,
                                                    load_reference_video_checkpoint)
from deeplip_tpu_torch.losses.softmax import build_criterion
from deeplip_tpu_torch.models.fusion import CompactBilinearPooling, LinearFusion, LowFER
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet
from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops import video as V
from deeplip_tpu_torch.ops.framing import frame_len_step, num_frames
from deeplip_tpu_torch.ops.masked import length_mask, masked_mean
from deeplip_tpu_torch.train import checkpoint as ckpt
from deeplip_tpu_torch.train.audio import claim_staged, compute_dtype_of, masked_cmvn, stage_arrays
from deeplip_tpu_torch.train.metrics import NanGuard, StepLogger
from deeplip_tpu_torch.train.schedules import multistep_schedule
from deeplip_tpu_torch.train.state import build_optimizer

FUSION_HEADS = ("lowfer", "linear", "cbp")


def _znorm(x: torch.Tensor) -> torch.Tensor:
    """Per-vector z-norm over the feature axis (population std)."""
    mu = x.mean(dim=-1, keepdim=True)
    std = x.std(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / std


def _masked_mean(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean of ``x (B, L, D)`` over each row's first ``lengths[b]`` entries;
    an empty row gives zeros."""
    return masked_mean(x, length_mask(lengths, x.shape[1], dtype=x.dtype)[..., None], axis=1)


class FusionTrainer:
    """``device=None`` runs on the card and raises where there is none.

    The recipe's defaults are the reference's: SGD at lr 0.5, momentum 0.9,
    coupled weight decay 1e-5, the rate times ``lr_decay`` at the epochs in
    ``lr_decay_step`` (``steps_per_epoch`` converts them to steps), and a
    CrossEntropy criterion. Weights are drawn from ``seed`` without touching
    the caller's global RNG."""

    def __init__(self, audio_model_opts, video_model_cfg, n_spk: int,
                 audio_data_opts=None, device: str | torch.device | None = None,
                 lr: float = 0.5, weight_decay: float = 1e-5, momentum: float = 0.9,
                 lr_decay_step=(4, 8), lr_decay: float = 0.1, steps_per_epoch: int = 1,
                 crop_size: tuple[int, int] = (88, 88), video_hidden_dim: int = 256,
                 video_trunk_layers=(2, 2, 2, 2), fusion_head: str = "lowfer",
                 loss: str = "CrossEntropy", exp_root: str = "exp",
                 log_time: str | None = None, seed: int = 0, compute_dtype: str = "float32",
                 mesh: Mesh | None = None, scale: float = 30.0, margin: float = 0.2):
        self.mesh = mesh if mesh is not None else local_mesh()
        if fusion_head not in FUSION_HEADS:
            raise NotImplementedError(f"fusion head {fusion_head!r}")
        self.compute_dtype = compute_dtype_of(compute_dtype)
        if fusion_head == "cbp" and self.compute_dtype is torch.bfloat16:
            raise ValueError("fusion head 'cbp' takes no bf16 embeddings: its rFFT refuses "
                             "bfloat16, as the JAX module's does; train it in float32")
        self.device = resolve_device(device)
        self.n_spk = n_spk
        self.crop_size = tuple(crop_size)
        self.feat_cfg = F.FeatureConfig.from_config(audio_data_opts or {})
        self.raw_feat_cfg = dataclasses.replace(self.feat_cfg, normalize=False, delta=False)
        self.fusion_head_name = fusion_head
        self.loss_name = loss
        self._criterion_opts = dict(scale=float(scale), margin=float(margin))
        self._audio_model_opts = audio_model_opts
        self._video_model_cfg = video_model_cfg
        self._video_kw = dict(hidden_dim=video_hidden_dim,
                              trunk_layers=tuple(video_trunk_layers))
        self.schedule = multistep_schedule(lr, list(lr_decay_step), lr_decay,
                                           max(int(steps_per_epoch), 1))
        self._sgd = dict(momentum=float(momentum), weight_decay=float(weight_decay))
        self.log_time = log_time or time.strftime("%b_%d_%H-%M-%S_%Y")
        self.exp_dir = os.path.join(exp_root, self.log_time)
        self.current_epoch = 0
        self.step = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.init_encoders(seed)

    # ------------------------------------------------------------------
    def init_encoders(self, seed: int = 0) -> None:
        """Build the two encoders, the head and the criterion with weights
        drawn from ``seed`` (the caller's global RNG is left as it was), the
        encoders frozen, everything in eval mode, and the optimizer over the
        live head parameters and the criterion."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.audio_model = SpeakerEmbNet.from_config(
                self._audio_model_opts, input_dim=F.feature_dim(self.feat_cfg))
            # the classifier is never run here; it only has to exist
            self.video_model = Lipreading.from_config(
                self._video_model_cfg, max(int(self.n_spk), 1), **self._video_kw)
            emb_dim = self.audio_model.fc2.out_features
            video_dim = self.video_model.backend_out
            if self.fusion_head_name == "lowfer":
                self.fusion_head = LowFER(input_dims=(emb_dim, video_dim), output_dim=emb_dim)
            elif self.fusion_head_name == "linear":
                self.fusion_head = LinearFusion(emb_dim + video_dim, hidden_size=emb_dim,
                                                extract_feats=True)
            else:
                self.fusion_head = CompactBilinearPooling((emb_dim, video_dim), emb_dim,
                                                          seed=seed)
            self.fusion_head.eval()
            with torch.no_grad():
                fused_dim = self._head_apply(torch.zeros(2, emb_dim),
                                             torch.zeros(2, video_dim)).shape[-1]
            # margin criteria at ``scale`` and ``margin`` (the reference's 30, 0.2)
            self.criterion = build_criterion(self.loss_name, max(int(self.n_spk), 1),
                                             fused_dim, **self._criterion_opts)
        for module in (self.audio_model, self.video_model):
            module.to(self.device).eval().requires_grad_(False)
        # the head trains in eval mode: LinearFusion's BN keeps its running
        # statistics, as the JAX head applies it
        self.fusion_head.to(self.device).eval()
        self.criterion.to(self.device)
        self.build_optimizer()

    def build_optimizer(self) -> None:
        """SGD over the live head parameters and the criterion's; call it
        again after changing the modules' dtype or device."""
        self.optimizer = build_optimizer(
            "sgd", {"fusion": self._live_head_params(),
                    "criterion": list(self.criterion.parameters())},
            self.schedule(self.step), **self._sgd)

    def _live_head_params(self) -> list[nn.Parameter]:
        """The head parameters that reach its output: a probe backward from
        ``sum(out ** 2)`` keeps each parameter whose gradient exists and is
        not all zero (the JAX package's ``any(g != 0)``)."""
        params = list(self.fusion_head.parameters())
        if not params:
            return []
        gen = torch.Generator().manual_seed(17)
        dtype = params[0].dtype
        e1 = torch.randn(2, self.audio_model.fc2.out_features, generator=gen, dtype=dtype)
        e2 = torch.randn(2, self.video_model.backend_out, generator=gen, dtype=dtype)
        with torch.enable_grad():
            out = self._head_apply(e1.to(self.device), e2.to(self.device))
            if not out.requires_grad:   # LowFER of equal dims: no parameter is live
                return []
            grads = torch.autograd.grad((out.float() ** 2).sum(), params, allow_unused=True)
        return [p for p, g in zip(params, grads) if g is not None and bool((g != 0).any())]

    def load_state_dicts(self, audio=None, video=None, head=None, criterion=None) -> None:
        """Load reference-layout state dicts (``strict=True``) into the
        audio encoder, the video encoder, the fusion head and the criterion;
        ``None`` keeps what is there. A video state dict trained on another
        number of classes resizes the unused classifier to fit."""
        if audio is not None:
            self.audio_model.load_state_dict(audio, strict=True)
        if video is not None:
            out = self.video_model.tcn.tcn_output
            rows = video["tcn.tcn_output.weight"].shape[0]
            if rows != out.out_features:
                self.video_model.tcn.tcn_output = nn.Linear(
                    out.in_features, rows).to(self.device).requires_grad_(False)
            self.video_model.load_state_dict(video, strict=True)
        if head is not None:
            self.fusion_head.load_state_dict(head, strict=True)
        if criterion is not None:
            self.criterion.load_state_dict(criterion, strict=True)

    @staticmethod
    def _read_state_dict(path: str, device) -> dict:
        """A checkpoint file of the port's as a state dict: a ``net_<tag>``
        (``{"epoch", "state_dict"}``) or a bare state dict. Reference DeepLip
        ``.pth`` files go through :meth:`load_torch_encoders` and
        :meth:`load_torch_fusion_head`."""
        tree = torch.load(path, map_location=device, weights_only=True)
        return tree["state_dict"] if "state_dict" in tree else tree

    def load_encoders(self, audio_ckpt: str | None, video_ckpt: str | None) -> None:
        """Load the frozen encoders from checkpoint files written by the
        audio and video trainers."""
        self.load_state_dicts(
            audio=self._read_state_dict(audio_ckpt, self.device) if audio_ckpt else None,
            video=self._read_state_dict(video_ckpt, self.device) if video_ckpt else None)

    def load_torch_encoders(self, audio_pth: str | None, video_pth: str | None) -> None:
        """Load the frozen encoders from reference DeepLip ``.pth`` files. The
        video file is merged over the video encoder's own state: only its
        classifier may be missing, or of another size."""
        self.load_state_dicts(
            audio=load_reference_audio_checkpoint(audio_pth) if audio_pth else None,
            video=load_reference_video_checkpoint(video_pth, self.video_model.state_dict())
            if video_pth else None)

    def load_torch_fusion_head(self, fusion_pth: str) -> None:
        """Load LowFER's ``U``/``V`` and, where the file has it, the criterion
        from a reference fusion ``net_*.pth`` (its pickled criterion module
        is read even though its class cannot be imported). The other head
        parameters, and the criterion where the file has none, keep theirs;
        the optimizer's momentum starts afresh. Only a LowFER head takes
        one."""
        if self.fusion_head_name != "lowfer":
            raise NotImplementedError(
                "reference fusion checkpoints hold LowFER U/V; construct the trainer with "
                "fusion_head='lowfer' to import one")
        head, crit = load_reference_fusion_checkpoint(fusion_pth)
        self.load_state_dicts(head={**self.fusion_head.state_dict(), **head}, criterion=crit)
        self.optimizer.state.clear()

    def load_head_checkpoint(self, path: str) -> None:
        """Load a fusion checkpoint file: this trainer's ``net_<epoch>``
        (the head as ``state_dict``, the criterion and the epoch), or a
        head-only file (a bare state dict, or ``state_dict`` alone). The
        optimizer's momentum starts afresh, as the reference's ``load``
        leaves it."""
        tree = torch.load(path, map_location=self.device, weights_only=True)
        if "state_dict" not in tree:
            tree = {"state_dict": tree}
        self._restore(tree)
        self.optimizer.state.clear()
        if "epoch" in tree:
            self.current_epoch = int(tree["epoch"])

    def _restore(self, tree: dict) -> None:
        self.load_state_dicts(head=tree["state_dict"], criterion=tree.get("criterion") or None)

    # ------------------------------------------------------------------
    def _head_apply(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        if self.fusion_head_name == "linear":
            return self.fusion_head(torch.cat([e1, e2], dim=-1))
        return self.fusion_head(e1, e2)

    def _video_group_embed(self, clips_u8: torch.Tensor, clip_lengths: torch.Tensor,
                           group_sizes: torch.Tensor,
                           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """``(B, G, T, H, W)`` uint8 -> ``(B, D)`` masked clip-group mean
        embedding; the frames computed in ``compute_dtype`` (default: the
        encoder's parameter type)."""
        b, g, t = clips_u8.shape[:3]
        x = V.eval_transform(clips_u8.reshape((b * g, t) + clips_u8.shape[3:]),
                             self.crop_size)[..., None]
        # zeroed pad frames equal the frontend conv's own zero padding, so
        # the dense batch matches a per-clip batch-1 loop
        x = V.mask_pad_frames(x, clip_lengths.reshape(b * g))
        dtype = compute_dtype or self._param_dtype(self.video_model)
        feats = self.video_model.frame_features(x, dtype)                # (B*G, T, D)
        clip_emb = _masked_mean(feats, clip_lengths.reshape(b * g))     # time mean per clip
        return _masked_mean(clip_emb.reshape(b, g, -1), group_sizes)   # group mean per item

    @staticmethod
    def _param_dtype(module: nn.Module) -> torch.dtype:
        return next(module.parameters()).dtype

    def _audio_embed(self, pcm: torch.Tensor) -> torch.Tensor:
        """The train step's audio x-vectors: the config's features (CMVN
        over each whole crop), the E-TDNN in ``compute_dtype``."""
        feats = F.extract_features(pcm, self.feat_cfg)
        xv, _ = self.audio_model.extract_embedding(feats, compute_dtype=self.compute_dtype)
        return xv

    # ------------------------------------------------------------------
    def train_step(self, pcm: torch.Tensor, clips_u8: torch.Tensor, clip_lengths: torch.Tensor,
                   group_sizes: torch.Tensor, labels: torch.Tensor) -> dict:
        """One SGD step of the head and the criterion from one paired batch
        on the device (under a mesh, this rank's rows): the frozen encoders,
        then :meth:`head_step`."""
        with fp32_math(), torch.no_grad():
            xv = self._audio_embed(pcm)
            em = self._video_group_embed(clips_u8, clip_lengths, group_sizes, self.compute_dtype)
        return self.head_step(xv, em, group_sizes, labels)

    def head_step(self, xv: torch.Tensor, em: torch.Tensor, group_sizes: torch.Tensor,
                  labels: torch.Tensor) -> dict:
        """The trained half of a step, from the encoders' ``(B, D)`` audio
        x-vectors and video group means: the head on them rounded to the
        train type, the criterion, the loss and accuracy over the rows with
        clips, the backward and the SGD update. Returns the step's ``loss``
        and ``acc`` as tensors on the device; the gradients stay in the
        parameters' ``.grad``."""
        mesh = self.mesh
        with fp32_math():
            train_dtype = self.compute_dtype or self._param_dtype(self.audio_model)
            valid = (group_sizes > 0).to(torch.float32)
            denom = torch.clamp(all_reduce(valid.sum(), mesh.data_group), min=1.0)
            fused = self._head_apply(xv.to(train_dtype), em.to(train_dtype))
            # the criterion takes the head's output in f32 (it promotes it to
            # its parameters' type where they are wider)
            per_ex, logits = self.criterion(fused.to(torch.float32), labels, reduction="none")
            loss = (per_ex * valid).sum() / denom
            acc = ((logits.argmax(-1) == labels) * valid).sum() / denom
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh.reduce_gradients([p for g in self.optimizer.param_groups for p in g["params"]])
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
        self.step += 1
        return mesh.report(loss=loss.detach(), acc=acc.detach())

    def rank_rows(self, batch: dict) -> dict:
        """A host batch padded with zero rows (group size 0) to a multiple of
        the batch ranks, and cut to this rank's rows."""
        keys = ("pcm", "clips", "clip_lengths", "group_sizes", "labels")
        pad = -len(batch["labels"]) % self.mesh.data_size
        out = {**batch, "n_real": len(batch["labels"])}
        for k in keys:
            arr = batch[k]
            if pad:
                arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
            out[k] = arr[self.mesh.rows(len(arr))]
        return out

    def _device_batches(self, source):
        """The pipeline's batches on the device, each one's copy started
        on the side stream before the previous batch's step runs."""
        keys = ("pcm", "clips", "clip_lengths", "group_sizes", "labels")
        pending = None
        for batch in source:
            staged = (batch, *stage_arrays([batch[k] for k in keys], self.device,
                                           self._copy_stream))
            if pending is not None:
                yield pending[0], claim_staged(pending[1], pending[2], self.device)
            pending = staged
        if pending is not None:
            yield pending[0], claim_staged(pending[1], pending[2], self.device)

    def train(self, pipeline, epochs: int = 1, auto_resume: bool = False) -> list[float]:
        """Train to ``epochs``, saving ``net_<epoch>`` after each;
        ``auto_resume`` first loads the newest ``net_<epoch>`` of the exp
        dir (weights and epoch; the step count goes on). Returns every
        step's loss."""
        if auto_resume:
            latest = ckpt.latest_checkpoint(self.exp_dir)
            if latest is not None and latest > self.current_epoch:
                tree = ckpt.load_checkpoint(self.exp_dir, latest, map_location=self.device)
                self._restore(tree)
                self.current_epoch = int(tree.get("epoch", 0))
        replicate(self.mesh, [*self.fusion_head.parameters(), *self.criterion.parameters()])
        os.makedirs(self.exp_dir, exist_ok=True)
        log_every = 10
        main = self.mesh.is_main
        logger = StepLogger(self.exp_dir if main else None,
                            print_every=log_every if main else 0, prefix="fusion")
        guard = NanGuard()
        losses: list[torch.Tensor] = []
        for epoch in range(self.current_epoch + 1, epochs + 1):
            self.current_epoch = epoch
            metrics, last_log, n_real = None, self.step, 0
            for batch, args in self._device_batches(
                    self.rank_rows(b) for b in pipeline.epoch(epoch)):
                n_real = batch["n_real"]
                metrics = self.train_step(*args)
                losses.append(metrics["loss"])
                # a metric read waits for the card: only on logging steps
                if self.step - last_log >= log_every:
                    last_log = self.step
                    loss = float(metrics["loss"])
                    guard.check(loss)
                    logger.log(self.step, examples=n_real, loss=loss,
                               acc=float(metrics["acc"]), epoch=epoch)
            if metrics is None:
                raise RuntimeError(f"epoch {epoch}: no batches produced — empty AV pairing "
                                   "or misconfigured pipeline?")
            if self.step != last_log:
                loss = float(metrics["loss"])
                guard.check(loss)
                logger.log(self.step, examples=n_real, loss=loss,
                           acc=float(metrics["acc"]), epoch=epoch)
            self.save(epoch)
        logger.close()
        return [float(v) for v in losses]

    # ------------------------------------------------------------------
    def save(self, epoch: int | None = None) -> str:
        """Write ``net_<epoch>``: the head as ``state_dict``, the criterion
        and the epoch."""
        epoch = self.current_epoch if epoch is None else epoch
        path = ckpt.checkpoint_path(self.exp_dir, epoch)
        if self.mesh.is_main:
            path = ckpt.save_checkpoint(self.exp_dir, epoch, {
                "epoch": epoch, "state_dict": self.fusion_head.state_dict(),
                "criterion": self.criterion.state_dict()})
        self.mesh.barrier()
        return path

    def model_average(self, avg_num: int = 2) -> None:
        """Average the last ``avg_num`` epoch checkpoints into ``net_avg``
        and load it."""
        epochs = [e for e in (self.current_epoch - i for i in range(avg_num)) if e >= 1]
        self._restore(ckpt.average_checkpoints(self.exp_dir, epochs))

    @torch.no_grad()
    def extract_pair_embedding(self, pcm, feat_lengths, clips_u8, clip_lengths, group_sizes,
                               use_fusion_head: bool = False, sample_lengths=None,
                               return_parts: bool = False):
        """Per-utterance fused test embedding of one padded batch (numpy
        arrays or tensors), as tensors on ``self.device``.

        Default: z-norm(audio xv) ++ z-norm(video group mean). With
        ``use_fusion_head`` the head's output; with ``return_parts`` the raw
        ``(audio_xv, video_em)`` pair.
        """
        if sample_lengths is None:
            sample_lengths = np.full((len(pcm),), pcm.shape[-1], np.int32)
        pcm, feat_lengths, sample_lengths, clips_u8, clip_lengths, group_sizes = (
            torch.as_tensor(a).to(self.device) for a in
            (pcm, feat_lengths, sample_lengths, clips_u8, clip_lengths, group_sizes))
        with fp32_math():
            # sample_lengths mask the pre-emphasis at each row's true end
            feats = F.extract_features(pcm, self.raw_feat_cfg, sample_lengths=sample_lengths)
            if self.feat_cfg.normalize:
                feats = masked_cmvn(feats, feat_lengths)
            if self.feat_cfg.delta:
                feats = F.add_deltas(feats, order=2)
            xv, _ = self.audio_model.extract_embedding(feats, lengths=feat_lengths)
            em = self._video_group_embed(clips_u8, clip_lengths, group_sizes)
            if return_parts:
                return xv, em
            if use_fusion_head:
                return self._head_apply(xv, em)
            return torch.cat([_znorm(xv), _znorm(em)], dim=-1)


def embed_av_items(trainer: FusionTrainer, items, *, max_clips: int = 2,
                   clip_frames: int = 32, use_fusion_head: bool = False,
                   return_parts: bool = False, chunk_size: int = 16):
    """Batched paired AV embeddings for ``(name, wav, clip_group)`` items.

    Chunks the items, pads PCM and clips into dense batches and runs
    :meth:`FusionTrainer.extract_pair_embedding` once per chunk. ``wav`` is a
    path or float32 PCM at the trainer's rate; each clip-group entry is an
    ``.npz``/``.npy`` path or a ``(T, H, W)`` uint8 array. Every clip is
    centre-cropped to the trainer's eval geometry before buffering, so
    corpora of mixed geometry share one buffer and the device-side centre
    crop is the identity; a clip smaller than the crop raises.

    Returns a fused :class:`EmbeddingStore` (tensors on the trainer's
    device), or with ``return_parts`` the ``(audio_store, video_store)`` pair.
    """
    store = EmbeddingStore()
    audio_store, video_store = EmbeddingStore(), EmbeddingStore()
    items = list(items)
    f_len, f_step = frame_len_step(trainer.feat_cfg.win_len, trainer.feat_cfg.win_shift,
                                   trainer.feat_cfg.rate)
    th, tw = trainer.crop_size

    def crop_to_eval(d: np.ndarray, label) -> np.ndarray:
        h, w = d.shape[1], d.shape[2]
        if h < th or w < tw:
            raise ValueError(f"clip {label!r} is {h}x{w}, smaller than the eval crop "
                             f"{th}x{tw} (train.crop_size): cannot extract")
        dh = int(round((h - th)) / 2.0)
        dw = int(round((w - tw)) / 2.0)
        return d[:, dh:dh + th, dw:dw + tw]

    def load_one_clip(c):
        if isinstance(c, str):
            return crop_to_eval(load_clip(c)[:clip_frames], c)
        return crop_to_eval(np.asarray(c, np.uint8)[:clip_frames], "array")

    for i in range(0, len(items), chunk_size):
        chunk = items[i:i + chunk_size]
        pcm_list, loaded = [], []
        for _name, wav, group in chunk:
            y = read_wav(wav)[0] if isinstance(wav, str) else np.asarray(wav, np.float32)
            pcm_list.append(y)
            loaded.append([load_one_clip(c) for c in list(group)[:max_clips]])
        b = len(chunk)
        pcm = np.zeros((b, max(len(y) for y in pcm_list)), np.float32)
        lengths = np.zeros((b,), np.int32)
        sample_lengths = np.zeros((b,), np.int32)
        clip_lengths = np.zeros((b, max_clips), np.int32)
        group_sizes = np.zeros((b,), np.int32)
        clips = np.zeros((b, max_clips, clip_frames, th, tw), np.uint8)
        for r, (y, group) in enumerate(zip(pcm_list, loaded)):
            pcm[r, :len(y)] = y
            lengths[r] = num_frames(len(y), f_len, f_step)
            sample_lengths[r] = len(y)
            for g, d in enumerate(group):
                clips[r, g, :len(d)] = d
                clip_lengths[r, g] = len(d)
            group_sizes[r] = len(group)
        out = trainer.extract_pair_embedding(
            pcm, lengths, clips, clip_lengths, group_sizes, use_fusion_head=use_fusion_head,
            sample_lengths=sample_lengths, return_parts=return_parts)
        for r, (name, _w, _g) in enumerate(chunk):
            if return_parts:
                audio_store[name], video_store[name] = out[0][r], out[1][r]
            else:
                store[name] = out[r]
    if return_parts:
        return audio_store, video_store
    return store
