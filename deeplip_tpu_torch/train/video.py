"""Video (lipreading) speaker-classification trainer and clip embedder.

Counterpart of ``deeplip_tpu/train/video.py: VideoTrainer`` on one device.
The recipe is the reference's (``train_video.py``): Adam(3e-4, coupled
weight decay 1e-4) with a CosineAnnealing(T_max=5) schedule stepped per
*iteration*, cross-entropy over speaker classes, per-epoch checkpoints, and
an extraction mode that writes ``(1, T, D)`` per-clip feature arrays
(``D`` the trunk's width: 512 for ResNet, 1024 or 2048 for ShuffleNetV2)
under key ``'data'`` in the reference's ``<out_root>/<spk>/<clip>.npz``
layout.

A train step ships the uint8 clip batch once and does everything else on
the device: random crop and flip, the affine, zeroed pad frames, the
Lipreading forward in train mode (its BN+PReLU sites through the fused
K3/K4 kernels on the card: nine with the ResNet trunk, the frontend's
alone with the ShuffleNetV2 one), the masked loss, the backward and the Adam
update. Every path runs in FP32 (no TF32), the precision the reference
holds its bars in, except the train step under ``compute_dtype='bf16'``:
its frame path (frontend, max-pool, and the ResNet trunk; the ShuffleNetV2
trunk stays f32, as the JAX model promotes it) runs in bf16 with f32
parameters, BN statistics in f32, and the TCN, classifier and loss in
FP32; extraction stays FP32, as in the JAX package.

With ``steps_per_dispatch: K > 1``, K consecutive same-shape batches run as
one group, flushed as the JAX trainer flushes them: one captured CUDA graph
of K steps on the card (``train.dispatch``), K eager steps on the CPU; a
partial run (a shape change, the end of an epoch) runs as single steps. The
crop offsets and flips of a group are drawn on the host in the order K
single steps draw them, and reach the graph, with each step's rate, through
its input buffers.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

import numpy as np
import torch

from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.data.video_dataset import VideoClipBatches
from deeplip_tpu_torch.eval.scoring import EmbeddingStore
from deeplip_tpu_torch.losses.softmax import softmax_cross_entropy
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.ops import video as V
from deeplip_tpu_torch.ops.masked import length_mask
from deeplip_tpu_torch.train import checkpoint as ckpt
from deeplip_tpu_torch.train.audio import compute_dtype_of, device_scalar, fp32_math
from deeplip_tpu_torch.train.dispatch import GroupedSteps
from deeplip_tpu_torch.train.metrics import NanGuard, StepLogger
from deeplip_tpu_torch.train.schedules import cosine_annealing_schedule
from deeplip_tpu_torch.train.state import torch_adam


class VideoTrainer:
    """``device=None`` runs on the card and raises where there is none."""

    def __init__(self, model_cfg, num_classes: int, device: str | torch.device | None = None,
                 lr: float = 3e-4, weight_decay: float = 1e-4, t_max: int = 5,
                 crop_size: tuple[int, int] = (88, 88), exp_root: str = "exp",
                 log_time: str | None = None, hidden_dim: int = 256,
                 trunk_layers=(2, 2, 2, 2), seed: int = 0, compute_dtype: str = "float32",
                 steps_per_dispatch: int = 1):
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.num_classes = num_classes
        self.crop_size = tuple(crop_size)
        # seeded init that leaves the caller's global RNG as it was
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = Lipreading.from_config(
                model_cfg, num_classes, hidden_dim=hidden_dim,
                trunk_layers=tuple(trunk_layers))
        self.model.to(self.device)
        self.schedule = cosine_annealing_schedule(lr, t_max)
        self.optimizer = torch_adam(self.model.parameters(), lr, weight_decay=weight_decay)
        self.log_time = log_time or time.strftime("%b_%d_%H-%M-%S_%Y")
        self.exp_dir = os.path.join(exp_root, self.log_time)
        self.current_epoch = 0
        self.step = 0
        self._rate = device_scalar(self.device)
        self.grouped = GroupedSteps(self._group_body, self._state_tensors, self.device,
                                    prepare=self.optimizer.init_state)

    # ------------------------------------------------------------------
    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step updates in place."""
        return ([*self.model.parameters(), *self.model.buffers()]
                + [t for s in self.optimizer.state.values() for t in s.values()])

    def train_step(self, clips_u8: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, generator: torch.Generator) -> dict:
        """One optimizer step from a uint8 ``(B, T, H, W)`` batch on the
        device; ``generator`` draws the crop offsets and flips."""
        dh, dw = V.crop_offsets(clips_u8, self.crop_size, generator)
        flip = V.flip_flags(clips_u8.shape[0], generator)
        return self.train_step_frames(self._train_frames(clips_u8, lengths, dh, dw, flip),
                                      lengths, labels)

    def _train_frames(self, clips_u8, lengths, dh, dw, flip) -> torch.Tensor:
        """The train transform at the given draws, ``(B, T, H, W, 1)`` in the
        parameters' type (f32 pixels meet f64 weights as Flax promotes
        them)."""
        x = V.train_transform_at(clips_u8, dh, dw, flip, self.crop_size)[..., None]
        # zero the pad frames after the transform. A length-0 row (a pad row
        # that repeats row 0's pixels) is masked with row 0's length, so the
        # BN statistics never see normalised black pad frames
        x = V.mask_pad_frames(x, torch.where(lengths > 0, lengths, lengths[0]))
        return x.to(next(self.model.parameters()).dtype)

    def train_step_frames(self, x: torch.Tensor, lengths: torch.Tensor,
                          labels: torch.Tensor) -> dict:
        """One optimizer step from already transformed frames
        ``(B, T, H, W, 1)``. Rows of length 0 are left out of the loss and
        the accuracy. Returns the step's ``loss`` and ``acc`` as tensors on
        the device; the gradients stay in the parameters' ``.grad``."""
        self._rate.fill_(self.schedule(self.step))
        metrics = self._frames_step(x, lengths, labels, self._rate)
        self.step += 1
        return metrics

    def train_group(self, clips_u8: torch.Tensor, lengths: torch.Tensor,
                    labels: torch.Tensor, draws: dict) -> dict:
        """K optimizer steps from ``(K, B, T, H, W)`` uint8 clips and ``(K,
        B)`` lengths and labels on the device, as one dispatch; ``draws``
        holds each step's crop offsets and flips (``dh``, ``dw``, ``flip``,
        ``(K, B)`` each). Returns every step's ``loss`` and ``acc`` as
        ``(K,)`` tensors."""
        k = clips_u8.shape[0]
        rates = torch.tensor([self.schedule(self.step + i) for i in range(k)],
                             dtype=torch.float64)
        inputs = {"clips": clips_u8, "lengths": lengths, "labels": labels,
                  **{n: v.to(self.device, non_blocking=True) for n, v in draws.items()}}
        metrics = self.grouped.run(inputs, {"rate": rates})
        self.step += k
        return metrics

    def _group_body(self, i: int, inputs, scalars) -> dict:
        lengths = inputs["lengths"][i]
        x = self._train_frames(inputs["clips"][i], lengths, inputs["dh"][i], inputs["dw"][i],
                               inputs["flip"][i])
        return self._frames_step(x, lengths, inputs["labels"][i], scalars["rate"][i])

    def _frames_step(self, x, lengths, labels, rate) -> dict:
        """One step at the device-tensor ``rate``; it touches no Python
        number that changes from step to step, so a CUDA graph can capture
        it."""
        self.model.train()
        valid = (lengths > 0).to(torch.float32)
        denom = torch.clamp(valid.sum(), min=1.0)
        with fp32_math():
            logits = self.model(x, lengths=torch.clamp(lengths, min=1),
                                compute_dtype=self.compute_dtype)
            per_ex = softmax_cross_entropy(logits, labels, reduction="none")
            loss = (per_ex * valid).sum() / denom
            acc = ((logits.argmax(-1) == labels) * valid).sum() / denom
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step(rate)
        return {"loss": loss.detach(), "acc": acc.detach()}

    def _flush(self, pending: list, generator: torch.Generator, losses: list) -> dict:
        """Run the pending same-shape batches: one group for a full run of
        K > 1, single steps otherwise, as the JAX trainer's ``flush`` does.
        Returns the last step's metrics."""
        device_args = [[torch.from_numpy(p[k]).to(self.device, non_blocking=True)
                        for k in ("clips", "lengths", "labels")] for p in pending]
        if len(pending) == self.steps_per_dispatch > 1:
            size = self.crop_size
            draws = []
            for p in pending:   # the order in which single steps draw them
                dh, dw = V.crop_offsets(torch.from_numpy(p["clips"]), size, generator)
                draws.append((dh, dw, V.flip_flags(len(p["labels"]), generator)))
            group = self.train_group(
                *(torch.stack(a) for a in zip(*device_args)),
                {n: torch.stack(d) for n, d in zip(("dh", "dw", "flip"), zip(*draws))})
            losses.extend(group["loss"])
            return {k: v[-1] for k, v in group.items()}
        for clips, lengths, labels in device_args:
            metrics = self.train_step(clips, lengths, labels, generator)
            losses.append(metrics["loss"])
        return metrics

    def train(self, batches: VideoClipBatches, epochs: int = 1, seed: int = 0,
              auto_resume: bool = False) -> list[float]:
        """Train to ``epochs``; returns every step's loss."""
        if auto_resume:
            latest = ckpt.latest_checkpoint(self.exp_dir)
            if latest is not None and latest > self.current_epoch:
                self.load(os.path.join(self.exp_dir, f"net_{latest}"))
        os.makedirs(self.exp_dir, exist_ok=True)
        log_every = 10
        logger = StepLogger(self.exp_dir, print_every=log_every, prefix="video")
        guard = NanGuard()
        generator = torch.Generator().manual_seed(seed)
        losses: list[torch.Tensor] = []
        for epoch in range(self.current_epoch + 1, epochs + 1):
            self.current_epoch = epoch
            metrics, b, last_log, pending = None, 0, self.step, []
            for batch in batches.epoch(epoch):
                b = len(batch["labels"])
                if pending and pending[-1]["clips"].shape != batch["clips"].shape:
                    metrics = self._flush(pending, generator, losses)
                    pending = []
                pending.append(batch)
                if len(pending) < self.steps_per_dispatch:
                    continue
                metrics = self._flush(pending, generator, losses)
                pending = []
                if self.step - last_log >= log_every:
                    last_log = self.step
                    loss = float(metrics["loss"])
                    guard.check(loss)
                    logger.log(self.step, examples=b, loss=loss, acc=float(metrics["acc"]),
                               lr=self.schedule(self.step), epoch=epoch)
            if pending:
                metrics = self._flush(pending, generator, losses)
            if metrics is None:
                raise RuntimeError(f"epoch {epoch}: no batches produced — is the clip "
                                   "directory empty or fully filtered out?")
            guard.check(float(metrics["loss"]))
            logger.log(self.step, examples=b, loss=float(metrics["loss"]),
                       acc=float(metrics["acc"]), lr=self.schedule(self.step), epoch=epoch)
            self.save(epoch)
        logger.close()
        return [float(v) for v in losses]

    # ------------------------------------------------------------------
    def save(self, epoch: int | None = None) -> str:
        epoch = self.current_epoch if epoch is None else epoch
        return ckpt.save_checkpoint(self.exp_dir, epoch, {
            "epoch": epoch, "state_dict": self.model.state_dict()})

    def load(self, path_or_tag: str) -> None:
        exp_dir, tag = os.path.split(path_or_tag.rstrip("/"))
        tree = ckpt.load_checkpoint(exp_dir or self.exp_dir, tag, map_location=self.device)
        self.model.load_state_dict(tree["state_dict"], strict=True)
        self.current_epoch = int(tree.get("epoch", 0))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def frame_features(self, clips_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Eval-mode ``(B, T, D)`` frame features of a uint8 batch."""
        self.model.eval()
        with fp32_math():
            x = V.eval_transform(clips_u8, self.crop_size)[..., None]
            # zeroed pad frames equal the conv's own zero padding, so a
            # padded batch extracts as each clip alone would
            return self.model.frame_features(V.mask_pad_frames(x, lengths))

    def _batches_on_device(self, batches: VideoClipBatches):
        for batch in batches.epoch(0):
            yield batch, (torch.from_numpy(batch["clips"]).to(self.device, non_blocking=True),
                          torch.from_numpy(batch["lengths"]).to(self.device))

    def extract_clip_features(self, batches: VideoClipBatches,
                              out_root: str | None = None) -> dict[str, np.ndarray]:
        """Per-clip ``(T_valid, D)`` frame features; with ``out_root``,
        also saved as ``(1, T, D)`` arrays in ``<out_root>/<name>.npz``."""
        out = {}
        for batch, (clips, lengths) in self._batches_on_device(batches):
            feats = self.frame_features(clips, lengths).cpu().numpy()
            for i, name in enumerate(batch["names"]):
                out[name] = feats[i, :int(batch["lengths"][i])]
                if out_root:
                    path = os.path.join(out_root, name + ".npz")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    np.savez(path, data=out[name][None])
        return out

    def extract_clip_embeddings(self, batches: VideoClipBatches) -> dict[str, torch.Tensor]:
        """Per-clip time-mean embeddings ``{name: (D,)}``, reduced on the
        device over each clip's valid frames; the tensors stay there."""
        out = {}
        for batch, (clips, lengths) in self._batches_on_device(batches):
            feats = self.frame_features(clips, lengths)
            mask = length_mask(lengths, feats.shape[1], dtype=feats.dtype)
            emb = (feats * mask[..., None]).sum(dim=1) / torch.clamp(
                lengths, min=1).to(feats.dtype)[:, None]
            for i, name in enumerate(batch["names"]):
                out[name] = emb[i]
        return out

    def embedding_store(self, batches: VideoClipBatches, name_map=None) -> EmbeddingStore:
        """Utterance-level embeddings: the mean of each utterance's clip
        embeddings; ``name_map`` maps a clip name to its utterance (default:
        the clip itself)."""
        groups: dict[str, list[torch.Tensor]] = defaultdict(list)
        for clip_name, vec in self.extract_clip_embeddings(batches).items():
            groups[name_map(clip_name) if name_map else clip_name].append(vec)
        store = EmbeddingStore()
        for utt, vecs in groups.items():
            store[utt] = torch.stack(vecs).mean(dim=0)
        return store

    @torch.no_grad()
    def classify_logits(self, clips_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Eval-mode logits of a uint8 batch on the device."""
        self.model.eval()
        with fp32_math():
            x = V.mask_pad_frames(V.eval_transform(clips_u8, self.crop_size)[..., None],
                                  lengths)
            return self.model(x, lengths=lengths)
