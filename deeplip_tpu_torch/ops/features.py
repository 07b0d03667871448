"""Batched audio feature extraction (MFCC / fbank / logfbank) on tensors.

Counterpart of ``deeplip_tpu/ops/features.py``. The plain front-end is a
function of a ``(B, S)`` PCM batch:

    frames  = unfold(signal)                          # (B, T, frame_len)
    spec    = (frames @ cos)^2 + (frames @ sin)^2     # / n_fft
    mel     = spec @ mel_fb                           # 0 → _PSF_EPS
    feat    = log(mel) @ dct * lifter                 # MFCC; c0 ← log energy

with the same f32 bases (cast from the f64 ``spectral`` arrays) and guards as
the JAX package's ``dft='matmul'`` path; ``dft='fft'`` takes the spectrum
from ``torch.fft.rfft`` instead, as the JAX package's does from
``jnp.fft.rfft``. :func:`extract_features` routes the mel front-ends,
pre-emphasis and length mask included, through the fused CUDA kernels
(``ops/cuda/fbank.py``) on a CUDA tensor, whatever ``dft`` says (as the JAX
package's ``pallas`` backend does); the kernels' wrapper falls to this plain
version only for a tensor on the CPU.

Not ported yet: the ``stft`` front-end and the ``dft`` variants
``matmul_fused`` and ``matmul_packed``; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Mapping

import numpy as np
import torch

from deeplip_tpu_torch.ops import framing, spectral

# python_speech_features guards log(0)/div-by-0 with numpy double eps.
_PSF_EPS = float(np.finfo(np.float64).eps)

MEL_FEATURES = ("mfcc", "fbank", "logfbank")


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Static feature-extraction parameters; names and defaults mirror the
    ``python_data_config`` section of the audio config. ``feat_type``
    selects the front-end, ``num_bin`` is the mel filter count, ``num_cep``
    the MFCC cepstra; ``energy`` replaces c0 with log-energy; ``normalize``
    applies per-utterance CMVN; ``delta`` appends Δ/ΔΔ."""

    feat_type: str = "mfcc"
    rate: int = 16000
    n_fft: int = 512
    num_bin: int = 26
    num_cep: int = 24
    energy: bool = True
    normalize: bool = True
    delta: bool = False
    win_len: float = 0.025
    win_shift: float = 0.01
    preemph: float = 0.97
    ceplifter: int = 22
    low_freq: float = 0.0
    high_freq: float | None = None
    # rDFT implementation of the plain front-end: 'matmul' (dense cos/sin
    # bases) or 'fft' (torch.fft.rfft); the others are not ported
    dft: str = "matmul"

    @classmethod
    def from_config(cls, data_opts: Mapping[str, Any]) -> "FeatureConfig":
        """Build from the nested audio data config (``rate``/``feat_type``
        plus a per-type sub-dict selected by ``feat_type``)."""
        rate = int(data_opts.get("rate", 16000))
        feat_type = data_opts.get("feat_type", "mfcc")
        sub = dict(data_opts.get(feat_type, {}))
        kw: dict[str, Any] = {"feat_type": feat_type, "rate": rate}
        if data_opts.get("dft"):
            kw["dft"] = str(data_opts["dft"])
        for key in ("n_fft", "num_bin", "num_cep", "energy", "normalize",
                    "delta", "win_len", "win_shift"):
            if key in sub:
                kw[key] = sub[key]
        return cls(**kw)

    @property
    def frame_len(self) -> int:
        return framing.round_half_up(self.win_len * self.rate)

    @property
    def frame_step(self) -> int:
        return framing.round_half_up(self.win_shift * self.rate)


def feature_dim(cfg: FeatureConfig) -> int:
    """Output feature dimension for a config (after delta stacking)."""
    if cfg.feat_type == "mfcc":
        base = cfg.num_cep
    elif cfg.feat_type in ("fbank", "logfbank"):
        base = cfg.num_bin
    elif cfg.feat_type == "stft":
        base = cfg.n_fft // 2 + 1
    else:
        raise NotImplementedError(f"unknown feat_type {cfg.feat_type!r}")
    if cfg.delta:
        base *= 3
    return base


@lru_cache(maxsize=64)
def _cached_const(fn, args: tuple, dtype: torch.dtype, device: torch.device):
    out = fn(*args)
    if isinstance(out, tuple):
        return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in out)
    return torch.as_tensor(out, dtype=dtype, device=device)


def _const(like: torch.Tensor, fn, *args):
    """``spectral.fn(*args)`` as tensor(s) of ``like``'s dtype on its device,
    made once per device."""
    return _cached_const(fn, args, like.dtype, like.device)


PORTED_DFTS = ("matmul", "fft")


def _check_dft(cfg: FeatureConfig) -> None:
    if cfg.dft not in PORTED_DFTS:
        raise NotImplementedError(
            f"dft={cfg.dft!r} is not ported; only {PORTED_DFTS} are")


def _power_spectrum(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Pre-emphasis → frames → |rDFT|²/n_fft, ``(..., T, n_fft//2+1)``.
    No analysis window (python_speech_features' ``winfunc`` is all-ones)."""
    _check_dft(cfg)
    emph = framing.preemphasis(signal, cfg.preemph)
    frames = framing.frame_signal(emph, cfg.frame_len, cfg.frame_step)
    if cfg.dft == "fft":
        spec = torch.fft.rfft(frames, n=cfg.n_fft)
        re, im = spec.real, spec.imag
    else:
        cos_m, sin_m = _const(frames, spectral.rdft_matrices, cfg.frame_len, cfg.n_fft)
        re = frames @ cos_m
        im = frames @ sin_m
    return (re * re + im * im) / cfg.n_fft


def _mel_energies(signal: torch.Tensor, cfg: FeatureConfig):
    pspec = _power_spectrum(signal, cfg)
    energy = pspec.sum(dim=-1)
    energy = energy.masked_fill(energy == 0, _PSF_EPS)
    fb = _const(pspec, spectral.mel_filterbank, cfg.num_bin, cfg.n_fft, cfg.rate,
                cfg.low_freq, cfg.high_freq)
    feat = pspec @ fb
    feat = feat.masked_fill(feat == 0, _PSF_EPS)
    return feat, energy


def fbank(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Linear mel filterbank energies ``(..., T, num_bin)`` (not log)."""
    feat, _ = _mel_energies(signal, cfg)
    return feat


def logfbank(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    feat, _ = _mel_energies(signal, cfg)
    return torch.log(feat)


def mfcc(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """MFCC ``(..., T, num_cep)`` with liftering and optional log-energy c0."""
    feat, energy = _mel_energies(signal, cfg)
    logm = torch.log(feat)
    cep = logm @ _const(logm, spectral.dct_matrix, cfg.num_cep, cfg.num_bin)
    cep = cep * _const(cep, spectral.cepstral_lifter, cfg.num_cep, cfg.ceplifter)
    if cfg.energy:
        cep = torch.cat([torch.log(energy)[..., None], cep[..., 1:]], dim=-1)
    return cep


def cmvn(feat: torch.Tensor, eps: float = 2e-12) -> torch.Tensor:
    """Per-utterance CMVN over time: population std (ddof=0) with
    ``+2e-12`` in the denominator, the reference's formula."""
    mean = feat.mean(dim=-2, keepdim=True)
    std = feat.std(dim=-2, keepdim=True, unbiased=False)
    return (feat - mean) / (std + eps)


def delta(feat: torch.Tensor, n: int = 2) -> torch.Tensor:
    """Regression deltas over time with edge padding (psf ``base.delta``):
    ``d[t] = sum_{k=1..n} k (x[t+k] - x[t-k]) / (2 sum k^2)``."""
    if n < 1:
        raise ValueError("delta order must be >= 1")
    denom = 2.0 * sum(k * k for k in range(1, n + 1))
    t = feat.shape[-2]
    first = feat[..., :1, :].expand(*feat.shape[:-2], n, feat.shape[-1])
    last = feat[..., -1:, :].expand(*feat.shape[:-2], n, feat.shape[-1])
    padded = torch.cat([first, feat, last], dim=-2)
    total = torch.zeros_like(feat)
    for k in range(-n, n + 1):
        if k == 0:
            continue
        total = total + k * padded[..., k + n: k + n + t, :]
    return total / denom


def add_deltas(feat: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Stack ``[feat, Δ, (ΔΔ)]`` on the channel axis."""
    if order == 1:
        return torch.cat([feat, delta(feat, 1)], dim=-1)
    if order == 2:
        return torch.cat([feat, delta(feat, 1), delta(feat, 2)], dim=-1)
    raise ValueError("delta order must be 1 or 2")


def extract_features(
    signal: torch.Tensor,
    cfg: FeatureConfig,
    sample_lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Feature → optional CMVN → optional Δ/ΔΔ, ``(..., S) -> (..., T, D)``.

    Mel front-ends go through the fused kernels' wrapper
    (``ops.cuda.fbank.audio_features``), which launches a CUDA kernel on a
    CUDA tensor and runs the plain version on a CPU tensor.

    ``sample_lengths`` marks the true PCM length of each row of a
    zero-padded batch. The reference pre-emphasises the exact-length signal
    and pads after; so with lengths given (and ``cfg.preemph`` nonzero, as
    in the JAX package), the wrapper pre-emphasises and zeroes each row
    from its length on. CMVN and deltas over a padded batch would average
    pad-derived frames, so they are refused with lengths: apply a masked
    CMVN downstream (``train.audio.masked_cmvn``).
    """
    if sample_lengths is not None and (cfg.normalize or cfg.delta):
        raise ValueError(
            "sample_lengths with cfg.normalize/cfg.delta would compute "
            "CMVN/delta statistics over padding-derived frames; use "
            "normalize=False, delta=False and a masked CMVN over the valid "
            "frames instead (see train.audio.masked_cmvn)")
    if cfg.feat_type not in MEL_FEATURES:
        raise NotImplementedError(
            f"feat_type {cfg.feat_type!r} is not ported; mel front-ends are")
    _check_dft(cfg)
    from deeplip_tpu_torch.ops.cuda.fbank import audio_features

    lengths = None
    if sample_lengths is not None and cfg.preemph:
        lengths = torch.as_tensor(sample_lengths).to(signal.device)
        lengths = lengths.expand(signal.shape[:-1]).reshape(-1)
    flat = signal.reshape(-1, signal.shape[-1]).contiguous()
    feat = audio_features(flat, cfg, lengths)
    feat = feat.reshape(*signal.shape[:-1], *feat.shape[-2:])
    if cfg.normalize:
        feat = cmvn(feat)
    if cfg.delta:
        feat = add_deltas(feat, order=2)
    return feat
