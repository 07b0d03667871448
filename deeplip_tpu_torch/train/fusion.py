"""Audio-visual fusion: frozen encoders, a fusion head, paired extraction.

Counterpart of the extraction half of ``deeplip_tpu/train/fusion.py``.
:class:`FusionTrainer` holds a frozen audio E-TDNN and a frozen video
Lipreading network, both in eval mode (BN running statistics, no dropout),
and a fusion head (LowFER by default). Clips are batched: the
``(B, G, T, H, W)`` clip tensor folds to ``(B·G, T, H, W)``, is embedded in
one pass, time-averaged per clip and group-averaged per item under masks.

Test-time extraction is the reference's live path: z-norm(audio x-vector)
++ z-norm(clip-group mean video embedding), the head bypassed;
``use_fusion_head`` returns the head's output instead, and ``return_parts``
the raw pair for score-level fusion.

The train step, its optimizer and the checkpoint averaging come with fusion
training.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
from torch import nn

from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.video_dataset import load_clip
from deeplip_tpu_torch.eval.scoring import EmbeddingStore
from deeplip_tpu_torch.models.fusion import LinearFusion, LowFER
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet
from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops import video as V
from deeplip_tpu_torch.ops.framing import frame_len_step, num_frames
from deeplip_tpu_torch.ops.masked import length_mask
from deeplip_tpu_torch.train.audio import masked_cmvn


def _znorm(x: torch.Tensor) -> torch.Tensor:
    """Per-vector z-norm over the feature axis (population std)."""
    mu = x.mean(dim=-1, keepdim=True)
    std = x.std(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / std


def _masked_mean(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean of ``x (B, L, D)`` over each row's first ``lengths[b]`` entries;
    an empty row gives zeros."""
    mask = length_mask(lengths, x.shape[1], dtype=x.dtype)[..., None]
    return (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)


class FusionTrainer:
    """``device=None`` runs on the card and raises where there is none."""

    def __init__(self, audio_model_opts, video_model_cfg, n_spk: int,
                 audio_data_opts=None, device: str | torch.device | None = None,
                 crop_size: tuple[int, int] = (88, 88), video_hidden_dim: int = 256,
                 video_trunk_layers=(2, 2, 2, 2), fusion_head: str = "lowfer",
                 exp_root: str = "exp", log_time: str | None = None, seed: int = 0):
        if fusion_head not in ("lowfer", "linear"):
            raise NotImplementedError(f"fusion head {fusion_head!r} is not ported yet")
        self.device = resolve_device(device)
        self.n_spk = n_spk
        self.crop_size = tuple(crop_size)
        self.feat_cfg = F.FeatureConfig.from_config(audio_data_opts or {})
        self.raw_feat_cfg = dataclasses.replace(self.feat_cfg, normalize=False, delta=False)
        self.fusion_head_name = fusion_head
        self._audio_model_opts = audio_model_opts
        self._video_model_cfg = video_model_cfg
        self._video_kw = dict(hidden_dim=video_hidden_dim,
                              trunk_layers=tuple(video_trunk_layers))
        self.log_time = log_time or time.strftime("%b_%d_%H-%M-%S_%Y")
        self.exp_dir = os.path.join(exp_root, self.log_time)
        self.init_encoders(seed)

    # ------------------------------------------------------------------
    def init_encoders(self, seed: int = 0) -> None:
        """Build the two encoders and the head with weights drawn from
        ``seed`` (the caller's global RNG is left as it was), frozen and in
        eval mode."""
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
            else:
                self.fusion_head = LinearFusion(emb_dim + video_dim, hidden_size=emb_dim,
                                                extract_feats=True)
        for module in (self.audio_model, self.video_model, self.fusion_head):
            module.to(self.device).eval().requires_grad_(False)

    def load_state_dicts(self, audio=None, video=None, head=None) -> None:
        """Load reference-layout state dicts (``strict=True``) into the
        audio encoder, the video encoder and the fusion head; ``None`` keeps
        what is there. A video state dict trained on another number of
        classes resizes the unused classifier to fit."""
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

    @staticmethod
    def _read_state_dict(path: str, device) -> dict:
        """A checkpoint file as a state dict: the port's ``net_<tag>``
        (``{"epoch", "state_dict"}``), a reference ``.pth`` of the same
        container, or a bare state dict."""
        tree = torch.load(path, map_location=device, weights_only=True)
        return tree["state_dict"] if "state_dict" in tree else tree

    def load_encoders(self, audio_ckpt: str | None, video_ckpt: str | None) -> None:
        """Load the frozen encoders from checkpoint files written by the
        audio and video trainers."""
        self.load_state_dicts(
            audio=self._read_state_dict(audio_ckpt, self.device) if audio_ckpt else None,
            video=self._read_state_dict(video_ckpt, self.device) if video_ckpt else None)

    def load_head_checkpoint(self, path: str) -> None:
        """Load a fusion-head checkpoint file."""
        self.load_state_dicts(head=self._read_state_dict(path, self.device))

    # ------------------------------------------------------------------
    def _head_apply(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        if self.fusion_head_name == "linear":
            return self.fusion_head(torch.cat([e1, e2], dim=-1))
        return self.fusion_head(e1, e2)

    def _video_group_embed(self, clips_u8: torch.Tensor, clip_lengths: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
        """``(B, G, T, H, W)`` uint8 -> ``(B, D)`` masked clip-group mean
        embedding."""
        b, g, t = clips_u8.shape[:3]
        x = V.eval_transform(clips_u8.reshape((b * g, t) + clips_u8.shape[3:]),
                             self.crop_size)[..., None]
        # zeroed pad frames equal the frontend conv's own zero padding, so
        # the dense batch matches a per-clip batch-1 loop
        x = V.mask_pad_frames(x, clip_lengths.reshape(b * g))
        feats = self.video_model.frame_features(x)                     # (B*G, T, D)
        clip_emb = _masked_mean(feats, clip_lengths.reshape(b * g))     # time mean per clip
        return _masked_mean(clip_emb.reshape(b, g, -1), group_sizes)   # group mean per item

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
