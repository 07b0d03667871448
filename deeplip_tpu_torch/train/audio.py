"""Audio x-vector training, extraction and scoring: the port of the JAX
package's ``AudioTrainer`` (``deeplip_tpu/train/audio.py``).

:class:`AudioTrainer` trains the config's ``model.arch`` (the TDNN/E-TDNN
with any of the five poolings, the ECAPA-TDNN, ``arch: ecapa``, or the
spectrogram ResNet, ``arch: resnet``) on speaker-balanced random crops
(``data.audio_pipeline.AudioTrainPipeline``). One train step ships the PCM
batch once (int16 where that is value-exact) and does everything else on
the device: the int16 → f32 rescale, the front-end (the fused FFT kernel on
the card), CMVN over each crop as the config asks, the forward in train
mode (bf16 conv blocks with ``train.compute_dtype: bf16``), the criterion
(LMCL by default, with its margin schedule), the backward and the SGD or
Adam step with the MultiStep learning rate. The next batch's host→device
copy is staged on a side stream while the current step runs. Per-epoch
``net_<epoch>`` checkpoints, resume with the learning-rate fast-forward,
finetuning of the head alone, and the average of the last epochs
(``net_avg``) follow the JAX trainer. With ``train.steps_per_dispatch: K >
1`` the sampler draws crop lengths in runs of K, and K consecutive
same-shape batches run as one group (:func:`group_batches`): one captured
CUDA graph of K steps on the card (``train.dispatch``), K eager steps on the
CPU; a partial run at the tail of an epoch runs as single steps. The
learning rate and the margin reach every step as tensors on the device.
With ``data.data_format: kaldi`` the batches are precomputed features from
Kaldi ark/scp tables (``data.kaldi_dataset.KaldiTrainPipeline``), and the
step skips the front-end and CMVN (:meth:`AudioTrainer.train_step_feats`).
``train.loader: native`` (the default) reads the wavs with the C++ decoder
(``deeplip_tpu_torch.native``) where it builds, ``python`` with the stdlib;
the batches are the same either way. A reference DeepLip
``.pth`` loads through :meth:`AudioTrainer.load_torch_checkpoint` and
:meth:`AudioExtractor.load_checkpoint`.

:class:`AudioExtractor` embeds bucketed PCM batches as ``_embed_fn`` does:
int16 → f32 rescale on the device, the front-end with pre-emphasis masked at
each row's true length, masked CMVN, the model, and L2 normalisation (or
the fc1 pre-activation for CrossEntropy systems). The ``stft`` front-end
counts each row's valid frames as librosa frames them (``1 + len // hop``),
not as the buckets' mel framing does. It stages the next
batch's host→device copy on a side stream while the current batch computes.

With ``mesh`` (``core.mesh``; one process per card, ``torchrun``) the
trainer is data-parallel as the JAX trainer is under its mesh: every rank
draws the same global batch and keeps its rows (the pipelines assemble the
whole batch, since each crop's draws follow the previous rows'), the BN
statistics are the global batch's, each rank's loss is its rows' share of
the global mean, and one all-reduce of the gradients after the backward
sums them; the reported loss and accuracy are all-reduced too. With
``model > 1`` the criterion's rows split over ``model``
(``losses.softmax.sharded_softmax_loss``). The triplet criterion mines over
the gathered global batch. Rank 0 writes the checkpoints and the logs, and
the parameters are broadcast from it before training. The extractor pads a
batch to the ranks with zero PCM of length 1, embeds its rows and
all-gathers the embeddings in order, so every rank holds the whole store.

Embedding math is pinned to FP32: cuDNN runs float32 convolutions in TF32
by default, which keeps about three digits and misses the 1e-4 embedding
bar. Train steps run inside the same pin, so the f32 recipe is FP32
throughout and the bf16 recipe keeps its criterion's cosine products and
FC head in FP32.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.core.mesh import Mesh, local_mesh, param_sharding, replicate
from deeplip_tpu_torch.core.spans import span
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch import native
from deeplip_tpu_torch.data.audio_pipeline import AudioTrainPipeline, EvalUtteranceSet
from deeplip_tpu_torch.data.kaldi_dataset import KaldiTrainPipeline
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList, cosine_eer
from deeplip_tpu_torch.interop.torch_import import load_reference_audio_checkpoint
from deeplip_tpu_torch.losses.softmax import (AAMSoftmax, LMCL, build_criterion,
                                              sharded_softmax_loss)
from deeplip_tpu_torch.losses.triplet import OnlineTripletLoss
from deeplip_tpu_torch.models.audio_resnet import AudioResNet
from deeplip_tpu_torch.models.ecapa import ECAPATDNN
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet
from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops.masked import length_mask
from deeplip_tpu_torch.train import checkpoint as ckpt
from deeplip_tpu_torch.train.dispatch import GroupedSteps
from deeplip_tpu_torch.train.metrics import NanGuard, StepLogger
from deeplip_tpu_torch.train.schedules import multistep_schedule
from deeplip_tpu_torch.train.state import build_optimizer


def masked_cmvn(feat: torch.Tensor, lengths: torch.Tensor,
                eps: float = 2e-12) -> torch.Tensor:
    """Per-utterance CMVN over only the valid frames of a padded batch."""
    mask = length_mask(lengths, feat.shape[1], dtype=feat.dtype)[..., None]
    count = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    mean = (feat * mask).sum(dim=1, keepdim=True) / count
    var = (((feat - mean) ** 2) * mask).sum(dim=1, keepdim=True) / count
    return (feat - mean) / (torch.sqrt(var) + eps)


def group_batches(source, k: int):
    """Stack runs of ``k`` consecutive same-shape PCM batches into ``(k, B,
    ...)`` group batches (``"group": k``), as the JAX package's
    ``_group_batches`` does. A shape change or a Kaldi-feature batch flushes
    the pending run; a partial run (the tail of an epoch or a bucket) comes
    out as its single batches."""
    pending = []

    def flush():
        if len(pending) == k and k > 1:
            return [{"pcm": np.stack([b["pcm"] for b in pending]),
                     "labels": np.stack([b["labels"] for b in pending]),
                     "n_frames": pending[-1]["n_frames"], "group": len(pending)}]
        return list(pending)

    for batch in source:
        if "feats" in batch:
            yield from flush()
            pending = []
            yield batch
            continue
        if pending and pending[-1]["pcm"].shape != batch["pcm"].shape:
            yield from flush()
            pending = []
        pending.append(batch)
        if len(pending) == k:
            yield from flush()
            pending = []
    yield from flush()


def device_scalar(device: torch.device) -> torch.Tensor:
    """A float64 0-d tensor on ``device`` for a per-step scalar (the rate,
    the margin) that a step reads on the device; each use casts it to the
    type it meets."""
    return torch.zeros((), dtype=torch.float64, device=device)


def stage_arrays(arrays, device: torch.device, stream):
    """Start the host→device copies of numpy ``arrays``; on the card they
    run on the side ``stream`` and the returned event marks their end.
    Returns ``(tensors, event or None)``."""
    host = [torch.from_numpy(a) for a in arrays]
    if stream is None:
        return [h.to(device) for h in host], None
    with torch.cuda.stream(stream):
        dev = [h.pin_memory().to(device, non_blocking=True) for h in host]
        done = torch.cuda.Event()
        done.record(stream)
    return dev, done


def claim_staged(tensors, done, device: torch.device):
    """Make the current stream wait for a staged copy before it reads the
    tensors, and keep their memory until it has."""
    if done is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in tensors:
            t.record_stream(stream)
    return tensors


def build_audio_model(model_opts, feature_dim: int) -> torch.nn.Module:
    """The config's ``model.arch``: the TDNN/E-TDNN or the ECAPA-TDNN over
    ``feature_dim`` features, or the spectrogram ResNet (one input
    channel)."""
    arch = model_opts.get("arch", "etdnn")
    if arch in ("tdnn", "etdnn"):
        return SpeakerEmbNet.from_config(model_opts, input_dim=feature_dim)
    if arch == "ecapa":
        return ECAPATDNN.from_config(model_opts, input_dim=feature_dim)
    if arch == "resnet":
        return AudioResNet.from_config(model_opts)
    raise NotImplementedError(f"audio arch {arch!r}")


def valid_feature_lengths(feats: torch.Tensor, feat_lengths: torch.Tensor,
                          sample_lengths: torch.Tensor, cfg: F.FeatureConfig) -> torch.Tensor:
    """Each row's valid frames: ``feat_lengths`` (the mel framing's count,
    the buckets' currency), or for ``stft`` librosa's ``1 + len // hop``
    columns, which the mel count falls short of."""
    if cfg.feat_type != "stft":
        return feat_lengths
    return torch.clamp(1 + sample_lengths.to(feat_lengths.dtype) // F.stft_hop(cfg),
                       max=feats.shape[-2])


class AudioExtractor:
    """Config-driven embedding extraction for the audio system.

    ``device=None`` runs on the card and raises where there is none. The
    config's ``python_data_config.backend`` (``xla|pallas``) is accepted,
    but the tensors' device picks the front-end. With ``mesh`` each rank
    embeds its rows of every batch and the ranks gather the embeddings.
    """

    def __init__(self, config: Config, device: str | torch.device | None = None,
                 mesh: Mesh | None = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh()
        self.cfg = Config(config)
        data_opts = self.cfg.get("data") or Config()
        feat_opts = data_opts.get("python_data_config") or Config()
        backend = feat_opts.get("backend", "xla")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown feature backend {backend!r}")
        self.feat_cfg = F.FeatureConfig.from_config(feat_opts)
        self.eval_feat_cfg = dataclasses.replace(
            self.feat_cfg, normalize=False, delta=False)
        self.model = build_audio_model(self.cfg.model, F.feature_dim(self.feat_cfg))
        self.model.to(self.device).eval()
        self.loss_name = (self.cfg.get("train") or Config()).get("loss", "LMCL")
        self.test_opts = self.cfg.get("test") or Config()
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def load_state_dict(self, state_dict) -> None:
        """Load reference-layout weights (``strict=True``)."""
        self.model.load_state_dict(state_dict, strict=True)

    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint file: ``{"epoch", "state_dict"}`` as the port's
        trainers save it, or a bare reference-layout state dict. A ``.pth``
        is read as a reference DeepLip checkpoint
        (:func:`~deeplip_tpu_torch.interop.torch_import.load_reference_audio_checkpoint`:
        the DataParallel prefix and ``fc3*`` keys are taken off)."""
        if str(path).endswith(".pth"):
            self.load_state_dict(load_reference_audio_checkpoint(path))
            return
        tree = torch.load(path, map_location=self.device, weights_only=True)
        self.load_state_dict(tree["state_dict"] if "state_dict" in tree else tree)

    @torch.no_grad()
    def embed(self, pcm: torch.Tensor, feat_lengths: torch.Tensor,
              sample_lengths: torch.Tensor) -> torch.Tensor:
        """One padded batch on ``self.device`` -> ``(B, E)`` embeddings."""
        self.model.eval()
        with span("deeplip.embed", self.device), fp32_math():
            with span("deeplip.input", self.device):
                if pcm.dtype == torch.int16:
                    # exact power-of-two rescale: PCM16 sources give the same
                    # float32 samples as the float32 transport
                    pcm = pcm.to(torch.float32) / 32768.0
                feats = F.extract_features(pcm, self.eval_feat_cfg,
                                           sample_lengths=sample_lengths)
                feat_lengths = valid_feature_lengths(feats, feat_lengths, sample_lengths,
                                                     self.feat_cfg)
                if self.feat_cfg.normalize:
                    feats = masked_cmvn(feats, feat_lengths)
                if self.feat_cfg.delta:
                    feats = F.add_deltas(feats, order=2)
            with span("deeplip.forward", self.device):
                xv, x_a = self.model.extract_embedding(feats, lengths=feat_lengths)
                if self.loss_name == "CrossEntropy":
                    # CE systems embed with the fc1 pre-activation
                    return x_a
                return xv / torch.linalg.vector_norm(
                    xv, dim=-1, keepdim=True).clamp(min=1e-12)

    def _stage(self, batch: dict):
        """Start the host→device copies of one batch (:func:`stage_arrays`):
        under a mesh, this rank's rows of the batch padded to the ranks with
        zero PCM of length 1 (the JAX extractor's mesh padding)."""
        arrays = [batch[k] for k in ("pcm", "feat_lengths", "sample_lengths")]
        if self.mesh.data_group is not None:
            pad = -len(batch["names"]) % self.mesh.data_size
            arrays = [np.concatenate([a, (np.zeros if i == 0 else np.ones)(
                (pad,) + a.shape[1:], a.dtype)]) for i, a in enumerate(arrays)]
            arrays = [a[self.mesh.rows(len(a))] for a in arrays]
        dev, done = stage_arrays(arrays, self.device, self._copy_stream)
        return batch["names"], dev, done

    def _embed_staged(self, staged, store: EmbeddingStore) -> None:
        names, args, done = staged
        out = self.mesh.gather_rows(self.embed(*claim_staged(args, done, self.device)))
        for i, name in enumerate(names):
            store[name] = out[i]

    def extract_embeddings(self, utterances: EvalUtteranceSet) -> EmbeddingStore:
        """Embed every utterance; the store keeps the tensors on the device.
        The next batch's copy is staged before the current batch computes."""
        store = EmbeddingStore()
        pending = None
        for batch in utterances.batches():
            staged = self._stage(batch)
            if pending is not None:
                self._embed_staged(pending, store)
            pending = staged
        if pending is not None:
            self._embed_staged(pending, store)
        return store

    def evaluate(self, trial_path: str, store: EmbeddingStore) -> tuple[float, float]:
        return cosine_eer(TrialList.load(trial_path), store, device=self.device)


_COMPUTE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "float32": None}


def compute_dtype_of(name: str, what: str = "compute_dtype") -> torch.dtype | None:
    """A config's ``compute_dtype`` name as the type a train step computes
    in: ``torch.bfloat16``, or None for the parameters' own."""
    if str(name) not in _COMPUTE_DTYPES:
        raise ValueError(f"{what} must be bf16 or float32, not {name!r}")
    return _COMPUTE_DTYPES[str(name)]


class AudioTrainer:
    """Config-driven x-vector trainer (``{data, model, train, test}``).

    ``device=None`` runs on the card and raises where there is none.
    ``n_spk`` overrides the manifest's speaker count (the criterion's
    classes). The weights are initialised from seed 0 without touching
    the caller's global RNG. Extraction and scoring go through
    :class:`AudioExtractor`, which shares the model. ``mesh``
    (``core.mesh.make_mesh``) trains data-parallel over its processes; the
    batch size must divide by its batch ranks.
    """

    def __init__(self, config: Config, device: str | torch.device | None = None,
                 exp_root: str = "exp", log_time: str | None = None,
                 n_spk: int | None = None, mesh: Mesh | None = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh()
        self.cfg = Config(config)
        self.data_opts = self.cfg.get("data") or Config()
        self.train_opts = self.cfg.get("train") or Config()
        self.test_opts = self.cfg.get("test") or Config()
        self.steps_per_dispatch = max(int(self.train_opts.get("steps_per_dispatch", 1)), 1)
        self.compute_dtype = compute_dtype_of(self.train_opts.get("compute_dtype", "float32"),
                                              "train.compute_dtype")

        self.manifest = None
        kaldi = None
        frame_range = tuple(self.data_opts.get("frames", (200, 400)))
        if self.data_opts.get("data_format", "python") == "kaldi":
            # precomputed features (the JAX trainer passes no seed and no
            # worker count from the config, and neither does this one)
            kcfg = (self.data_opts.get("kaldi_data_config") or Config()).get("trainset") or {}
            if kcfg.get("nn_spk2utt") and os.path.exists(str(kcfg["nn_spk2utt"])):
                kaldi = KaldiTrainPipeline(
                    kcfg["nn_spk2utt"], kcfg["nn_feat_scp"],
                    int(self.train_opts.get("bs", 256)), frame_range=frame_range,
                    n_buckets=int(self.train_opts.get("frame_buckets", 11)))
        else:
            manifest_path = self.data_opts.get("train_manifest")
            if manifest_path and os.path.exists(str(manifest_path)):
                self.manifest = SpeakerManifest.load(str(manifest_path))
        self.n_spk = n_spk if n_spk is not None else (
            self.manifest.n_spk if self.manifest else kaldi.n_spk if kaldi else 0)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.extractor = AudioExtractor(self.cfg, device=self.device, mesh=self.mesh)
            self.model = self.extractor.model
            margin_range = self.train_opts.get("margin", [0.2, 0.2])
            self.init_margin = float(margin_range[0])
            self.end_margin = float(margin_range[-1])
            self.loss_name = self.train_opts.get("loss", "LMCL")
            if self.loss_name == "Triplet":
                self.criterion = OnlineTripletLoss(
                    margin=self.init_margin,
                    strategy=self.train_opts.get("triplet_strategy", "hardest"),
                    mesh=self.mesh if self.mesh.data_group is not None else None)
                crit_params = []
            else:
                self.criterion = build_criterion(
                    self.loss_name, self.n_spk, self.model.fc2.out_features,
                    float(self.train_opts.get("scale", 30.0)), self.init_margin
                ).to(self.device)
                crit_params = list(self.criterion.parameters())
        self.feat_cfg = self.extractor.feat_cfg
        self._shards = self._shard_criterion()

        self.batch_size = int(self.train_opts.get("bs", 256))
        if self.batch_size % self.mesh.data_size:
            raise ValueError(f"train.bs {self.batch_size} does not split over "
                             f"{self.mesh.data_size} batch ranks")
        self.epochs = int(self.train_opts.get("epoch", 30))
        self.pipeline = kaldi
        if self.manifest is not None:
            # the native (C++, GIL-free) wav decoder where it builds; 'loader:
            # python' keeps the stdlib reader. Both are value-preserving, so
            # the int16 transport and the batches are the same either way.
            reader = read_wav
            if self.train_opts.get("loader", "native") == "native" and native.available():
                reader = native.read_wav
            self.pipeline = AudioTrainPipeline(
                self.manifest, self.batch_size, frame_range=frame_range,
                win_len=self.feat_cfg.win_len, win_shift=self.feat_cfg.win_shift,
                rate=self.feat_cfg.rate,
                n_buckets=int(self.train_opts.get("frame_buckets", 11)),
                num_workers=int(self.train_opts.get("loader_workers", 8)),
                reader=reader, transport=str(self.train_opts.get("transport", "auto")),
                bucket_run=self.steps_per_dispatch)

        steps_per_epoch = self.pipeline.batches_per_epoch() if self.pipeline else 1
        opt_type = self.train_opts.get("type", "sgd")
        opt_opts = self.train_opts.get(opt_type) or {"init_lr": 0.01}
        self.schedule = multistep_schedule(
            float(opt_opts.get("init_lr", 0.01)),
            self.train_opts.get("lr_decay_step", [15, 25]),
            float(self.train_opts.get("lr_decay", 0.1)),
            max(steps_per_epoch, 1))
        self.finetune = self.train_opts.get("train_type") == "finetune"
        if self.finetune:
            # the backbone gets no gradient, no update, no decay and no
            # momentum; its BN running statistics still follow the batches
            for p in self.model.parameters():
                p.requires_grad_(False)
        self.optimizer = build_optimizer(
            opt_type, {"model": self.model.parameters(), "criterion": crit_params},
            self.schedule(0), momentum=float(opt_opts.get("momentum", 0.9)),
            weight_decay=float(opt_opts.get("weight_decay", 0.0)),
            trainable_mask={"model": False, "criterion": True} if self.finetune else None)

        self.log_time = log_time or time.strftime("%b_%d_%H-%M-%S_%Y")
        self.exp_dir = os.path.join(exp_root, self.log_time)
        self.current_epoch = 0
        self.step = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._rate, self._margin = device_scalar(self.device), device_scalar(self.device)
        self.grouped = GroupedSteps(self._group_body, self._state_tensors, self.device,
                                    prepare=self.optimizer.init_state)
        self.replicate()

        self.loaded_checkpoint = False
        resume = self.train_opts.get("resume")
        if resume not in (None, "", "None", "null", "~"):   # yaml spellings of unset
            if not os.path.exists(str(resume)):
                # a mistyped path must fail loudly, not evaluate random weights
                raise FileNotFoundError(f"train.resume checkpoint not found: {resume}")
            if self.finetune:
                self.load_finetune(str(resume))
            else:
                self.load(str(resume))
            self.loaded_checkpoint = True

    # ------------------------------------------------------------------
    def ensure_state(self) -> dict:
        """The trainable state: the model, the criterion, the optimizer and
        the step count (built with the trainer)."""
        return {"model": self.model, "criterion": self.criterion,
                "optimizer": self.optimizer, "step": self.step}

    def _shard_criterion(self) -> dict:
        """With ``model > 1``, keep this rank's rows of the criterion's
        classifier (``core.mesh.param_sharding``); returns ``{name:
        RowSharding}`` of the sharded parameters."""
        if self.mesh.model_size == 1:
            return {}
        named = dict(self.criterion.named_parameters()) if self.loss_name != "Triplet" else {}
        shards = {n: r for n, r in param_sharding(
            self.mesh, {f"criterion.{n}": p for n, p in named.items()}).items() if r}
        if not shards:
            raise ValueError(f"a model axis of {self.mesh.model_size} needs a classifier whose "
                             f"rows divide by it; {self.loss_name} over {self.n_spk} has none")
        with torch.no_grad():
            for name, rows in shards.items():
                p = named[name.split(".", 1)[1]]
                p.data = rows(p.data).clone()
        self._class_offset = next(iter(shards.values())).rows(self.n_spk).start
        return {name.split(".", 1)[1]: rows for name, rows in shards.items()}

    def _replicated_params(self) -> list[torch.Tensor]:
        crit = [] if self.loss_name == "Triplet" else [
            p for n, p in self.criterion.named_parameters() if n not in self._shards]
        return [*self.model.parameters(), *crit]

    def _sharded_params(self) -> list[torch.Tensor]:
        named = dict(self.criterion.named_parameters()) if self._shards else {}
        return [named[n] for n in self._shards]

    def replicate(self) -> None:
        """Overwrite the weights, BN buffers and criterion with rank 0's (the
        sharded criterion rows with their batch group's first rank's)."""
        if self.mesh.world_group is None:
            return
        replicate(self.mesh, [*self._replicated_params(), *self.model.buffers()])
        self.mesh.broadcast([p.data for p in self._sharded_params()], self.mesh.data_group)

    def _criterion_apply(self, emb: torch.Tensor, labels: torch.Tensor, margin):
        """``(loss, correct)``: this rank's objective (its rows' share of the
        global loss; the whole loss for the triplet criterion, whose rows
        are gathered) and its rows' hits as a float ``(B,)``."""
        mesh = self.mesh
        margin_arg = (margin,) if isinstance(self.criterion, (LMCL, AAMSoftmax)) else ()
        if self.loss_name == "Triplet":
            loss, _count = self.criterion(emb, labels)
            # no classification logits: the JAX trainer's argmax of zero
            # logits, class 0
            return loss, (labels == 0).to(torch.float32)
        if self._shards:
            per_ex, hit = sharded_softmax_loss(self.criterion, emb, labels, self._class_offset,
                                               mesh.model_group, *margin_arg)
            penalty = self.criterion.penalty() if isinstance(self.criterion, LMCL) else 0.0
            # every model rank computes the same rows' loss: each takes 1/model
            # of it, and its own rows' penalty
            loss = mesh.local_share(per_ex.mean() / mesh.model_size + penalty)
            return loss, hit.to(torch.float32) / mesh.model_size
        loss, logits = self.criterion(emb, labels, *margin_arg)
        return mesh.local_share(loss), (logits.argmax(-1) == labels).to(torch.float32)

    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step updates in place."""
        modules = [m for m in (self.model, self.criterion) if isinstance(m, torch.nn.Module)]
        return ([t for m in modules for t in (*m.parameters(), *m.buffers())]
                + [t for s in self.optimizer.state.values() for t in s.values()])

    def _scalars(self, margin) -> tuple[torch.Tensor, torch.Tensor]:
        """This step's rate and margin as device tensors."""
        self._rate.fill_(self.schedule(self.step))
        if isinstance(margin, torch.Tensor):
            return self._rate, margin
        self._margin.fill_(float(margin))
        return self._rate, self._margin

    def train_step(self, pcm: torch.Tensor, labels: torch.Tensor, margin) -> dict:
        """One optimizer step from a ``(B, S)`` PCM batch on the device
        (int16 or float32); ``margin`` a float or a 0-d tensor. Returns the
        step's ``loss`` and ``acc`` as tensors on the device."""
        with span("deeplip.step", self.device), fp32_math():
            metrics = self._pcm_step(pcm, labels, *self._scalars(margin))
        self.step += 1
        return metrics

    def train_step_feats(self, feats: torch.Tensor, labels: torch.Tensor, margin) -> dict:
        """One optimizer step from precomputed ``(B, T, D)`` features (a
        Kaldi batch): no front-end and no CMVN, the rest as
        :meth:`train_step`, ``train.compute_dtype`` included."""
        with span("deeplip.step", self.device), fp32_math():
            metrics = self._step_on_features(feats, labels, *self._scalars(margin))
        self.step += 1
        return metrics

    def train_group(self, pcm: torch.Tensor, labels: torch.Tensor, margin: float) -> dict:
        """K optimizer steps from ``(K, B, S)`` PCM and ``(K, B)`` labels on
        the device, as one dispatch (:class:`~deeplip_tpu_torch.train.dispatch.GroupedSteps`).
        Returns every step's ``loss`` and ``acc`` as ``(K,)`` tensors."""
        k = pcm.shape[0]
        rates = torch.tensor([self.schedule(self.step + i) for i in range(k)],
                             dtype=torch.float64)
        with fp32_math():
            metrics = self.grouped.run(
                {"pcm": pcm, "labels": labels},
                {"rate": rates, "margin": torch.tensor([float(margin)], dtype=torch.float64)})
        self.step += k
        return metrics

    def _group_body(self, i: int, inputs, scalars) -> dict:
        return self._pcm_step(inputs["pcm"][i], inputs["labels"][i], scalars["rate"][i],
                              scalars["margin"][0])

    def _pcm_step(self, pcm, labels, rate, margin) -> dict:
        with span("deeplip.input", self.device):
            if pcm.dtype == torch.int16:
                # exact power-of-two rescale: PCM16 crops give the float32
                # transport's samples bit for bit
                pcm = pcm.to(torch.float32) / 32768.0
            feats = F.extract_features(pcm, self.feat_cfg)
        return self._step_on_features(feats, labels, rate, margin)

    def _step_on_features(self, feats, labels, rate, margin) -> dict:
        """One step at the device-tensor ``rate`` and ``margin``; it touches
        no Python number that changes from step to step, so a CUDA graph
        can capture it."""
        self.model.train()
        mesh = self.mesh
        with span("deeplip.forward", self.device):
            with mesh.batch_stats():
                emb = self.model(feats, compute_dtype=self.compute_dtype)
            loss, hits = self._criterion_apply(emb, labels, margin)
        with span("deeplip.backward", self.device):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh.reduce_gradients(self._replicated_params(), self._sharded_params())
        with span("deeplip.optimizer", self.device):
            self.optimizer.step(rate)
        # the triplet loss is the whole batch's on every rank
        share = mesh.local_share(loss.detach()) if self.loss_name == "Triplet" else loss.detach()
        return mesh.report(loss=share, acc=mesh.local_share(hits.mean()))

    def _margin_for_epoch(self, epoch: int) -> float:
        """The margin schedule: the init margin up to epoch 5, then the end
        margin."""
        return self.init_margin if epoch <= 5 else self.end_margin

    def _device_batches(self, source):
        """The pipeline's batches (``pcm`` or Kaldi ``feats``) on the
        device, this rank's rows of them, each one's copy started before the
        previous batch's step runs."""
        pending = None
        for batch in source:
            data = batch["feats"] if "feats" in batch else batch["pcm"]
            axis = 1 if "group" in batch else 0
            rows = (slice(None),) * axis + (self.mesh.rows(batch["labels"].shape[axis]),)
            staged = (batch, *stage_arrays([data[rows], batch["labels"][rows]], self.device,
                                           self._copy_stream))
            if pending is not None:
                yield pending[0], claim_staged(pending[1], pending[2], self.device)
            pending = staged
        if pending is not None:
            yield pending[0], claim_staged(pending[1], pending[2], self.device)

    def train(self, epochs: int | None = None, auto_resume: bool = False) -> list[float]:
        """Train to ``epochs`` (the config's by default), saving ``net_<epoch>``
        after each; ``auto_resume`` first loads the newest ``net_<epoch>`` of
        the exp dir. Returns every step's loss."""
        if self.pipeline is None:
            raise RuntimeError("no train manifest (or Kaldi trainset) configured")
        if auto_resume:
            latest = ckpt.latest_checkpoint(self.exp_dir)
            if latest is not None and latest > self.current_epoch:
                self.load(os.path.join(self.exp_dir, f"net_{latest}"))
        self.replicate()
        os.makedirs(self.exp_dir, exist_ok=True)
        log_every = int(self.train_opts.get("log_every", 20)) or 1
        main = self.mesh.is_main
        logger = StepLogger(self.exp_dir if main else None, print_every=log_every if main else 0)
        guard = NanGuard()
        epochs = self.epochs if epochs is None else epochs
        losses: list[torch.Tensor] = []
        for epoch in range(self.current_epoch + 1, epochs + 1):
            self.current_epoch = epoch
            margin = self._margin_for_epoch(epoch)
            metrics, last_log = None, self.step
            source = self.pipeline.epoch(epoch)
            if self.steps_per_dispatch > 1:
                source = group_batches(source, self.steps_per_dispatch)
            for batch, (data, labels) in self._device_batches(source):
                if "group" in batch:
                    group = self.train_group(data, labels, margin)
                    losses.extend(group["loss"])
                    metrics = {k: v[-1] for k, v in group.items()}
                elif "feats" in batch:
                    metrics = self.train_step_feats(data, labels, margin)
                    losses.append(metrics["loss"])
                else:
                    metrics = self.train_step(data, labels, margin)
                    losses.append(metrics["loss"])
                # a metric read waits for the card: only on logging steps
                if self.step - last_log >= log_every:
                    last_log = self.step
                    loss = float(metrics["loss"])
                    guard.check(loss)
                    logger.log(self.step, examples=batch["labels"].shape[-1], loss=loss,
                               acc=float(metrics["acc"]), lr=self.schedule(self.step),
                               epoch=epoch, n_frames=batch["n_frames"])
            if metrics is None:
                raise RuntimeError(f"epoch {epoch}: no batches produced — empty manifest "
                                   "or misconfigured pipeline?")
            guard.check(float(metrics["loss"]))
            self.save(epoch)
        logger.close()
        return [float(v) for v in losses]

    # ------------------------------------------------------------------
    def save(self, epoch: int | None = None) -> str:
        """Write ``net_<epoch>`` (rank 0 writes; every rank waits for it).
        Under ``model > 1`` the criterion is gathered whole and the
        optimizer state saved is rank 0's."""
        epoch = self.current_epoch if epoch is None else epoch
        tree = {"epoch": epoch, "state_dict": self.model.state_dict(),
                "criterion": self.criterion_state_dict(),
                "optimizer": self.optimizer.state_dict()}
        path = ckpt.checkpoint_path(self.exp_dir, epoch)
        if self.mesh.is_main:
            path = ckpt.save_checkpoint(self.exp_dir, epoch, tree)
        self.mesh.barrier()
        return path

    def criterion_state_dict(self) -> dict:
        """The criterion's state dict, its rows gathered from the ``model``
        ranks where they are split."""
        if self.loss_name == "Triplet":
            return {}
        state = self.criterion.state_dict()
        for name in self._shards:
            parts = [torch.empty_like(state[name]) for _ in range(self.mesh.model_size)]
            torch.distributed.all_gather(parts, state[name].contiguous(),
                                         group=self.mesh.model_group)
            state[name] = torch.cat(parts)
        return state

    def _restore_weights(self, tree: dict) -> None:
        self.model.load_state_dict(tree["state_dict"], strict=True)
        if tree.get("criterion") and self.loss_name != "Triplet":
            state = dict(tree["criterion"])
            for name, rows in self._shards.items():
                state[name] = rows(state[name])
            self.criterion.load_state_dict(state, strict=True)

    def _load_tree(self, path_or_tag: str) -> tuple[str, dict]:
        exp_dir, tag = os.path.split(path_or_tag.rstrip("/"))
        exp_dir = exp_dir or self.exp_dir
        return exp_dir, ckpt.load_checkpoint(exp_dir, tag, map_location=self.device)

    def load(self, path_or_tag: str, restore_optimizer: bool = False) -> None:
        """Resume the weights and the epoch from ``net_<epoch>``; with
        ``restore_optimizer``, the momentum too (off by default, as the
        reference leaves it). The step count moves to the epoch's end
        (epoch x batches per epoch), so the MultiStep rate resumes decayed."""
        exp_dir, tree = self._load_tree(path_or_tag)
        self._restore_weights(tree)
        if restore_optimizer and tree.get("optimizer"):
            self.optimizer.load_state_dict(tree["optimizer"])
        self.current_epoch = int(tree.get("epoch", 0))
        if self.current_epoch and self.pipeline:
            self.step = self.current_epoch * self.pipeline.batches_per_epoch()
        self.exp_dir = exp_dir
        self.log_time = os.path.basename(self.exp_dir)

    def load_torch_checkpoint(self, path: str) -> None:
        """Load the TDNN/E-TDNN of a reference DeepLip ``net_*.pth``; the
        criterion, the optimizer, the epoch and the step keep theirs."""
        self.model.load_state_dict(load_reference_audio_checkpoint(path), strict=True)

    def load_finetune(self, path_or_tag: str) -> None:
        """Load the backbone (weights and BN statistics) alone and keep the
        epoch at 0; the criterion keeps its fresh init, so finetuning onto
        another speaker count works."""
        _, tree = self._load_tree(path_or_tag)
        self.model.load_state_dict(tree["state_dict"], strict=True)

    def model_average(self, avg_num: int = 4) -> None:
        """Average the last ``avg_num`` epoch checkpoints into ``net_avg``
        and load it."""
        epochs = [e for e in (self.current_epoch - i for i in range(avg_num)) if e >= 1]
        self._restore_weights(ckpt.average_checkpoints(self.exp_dir, epochs))

    # ------------------------------------------------------------------
    def extract_embeddings(self, utterances: EvalUtteranceSet) -> EmbeddingStore:
        return self.extractor.extract_embeddings(utterances)

    def evaluate(self, trial_path: str, store: EmbeddingStore) -> tuple[float, float]:
        return self.extractor.evaluate(trial_path, store)
