"""Batched audio feature extraction (MFCC / fbank / logfbank / STFT) on tensors.

Counterpart of ``deeplip_tpu/ops/features.py``. The plain front-end is a
function of a ``(B, S)`` PCM batch:

    frames  = unfold(signal)                          # (B, T, frame_len)
    spec    = (frames @ cos)^2 + (frames @ sin)^2     # / n_fft
    mel     = spec @ mel_fb                           # 0 → _PSF_EPS
    feat    = log(mel) @ dct * lifter                 # MFCC; c0 ← log energy

with the same f32 bases (cast from the f64 ``spectral`` arrays) and guards as
the JAX package's ``dft='matmul'`` path; ``dft='fft'`` takes the spectrum
from ``torch.fft.rfft`` instead, as the JAX package's does from
``jnp.fft.rfft``. The JAX package's ``matmul_fused`` and ``matmul_packed``
compute the same per-bin dot products against bases laid out for the TPU's
matrix unit; here they name the ``matmul`` bases. :func:`extract_features`
routes the mel front-ends, pre-emphasis and length mask included, through
the fused CUDA kernels (``ops/cuda/fbank.py``) on a CUDA tensor, whatever
``dft`` says (as the JAX package's ``pallas`` backend does); the kernels'
wrapper falls to this plain version only for a tensor on the CPU.

The ``stft`` front-end (:func:`stft_features`, librosa's centred log1p
magnitude) is plain PyTorch on every device, as the JAX package has no
kernel for it.
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
    # rDFT implementation of the plain front-end: 'fft' (torch.fft.rfft)
    # or one of the matmul names (dense cos/sin bases)
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


DFTS = ("matmul", "matmul_fused", "matmul_packed", "fft")


def _check_dft(cfg: FeatureConfig) -> None:
    if cfg.dft not in DFTS:
        raise NotImplementedError(f"unknown dft impl {cfg.dft!r}; one of {DFTS}")


def _rdft(frames: torch.Tensor, cfg: FeatureConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``(re, im)`` of the real DFT of ``(..., T, L)`` frames zero-padded to
    ``n_fft``, ``(..., T, n_fft//2+1)`` each."""
    _check_dft(cfg)
    if cfg.dft == "fft":
        spec = torch.fft.rfft(frames, n=cfg.n_fft)
        return spec.real, spec.imag
    cos_m, sin_m = _const(frames, spectral.rdft_matrices, frames.shape[-1], cfg.n_fft)
    return frames @ cos_m, frames @ sin_m


def _power_spectrum(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Pre-emphasis → frames → |rDFT|²/n_fft, ``(..., T, n_fft//2+1)``.
    No analysis window (python_speech_features' ``winfunc`` is all-ones)."""
    emph = framing.preemphasis(signal, cfg.preemph)
    re, im = _rdft(framing.frame_signal(emph, cfg.frame_len, cfg.frame_step), cfg)
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


def stft_hop(cfg: FeatureConfig) -> int:
    """The ``stft`` front-end's hop in samples (truncated, as librosa's
    caller computes it)."""
    return int(cfg.rate * cfg.win_shift)


def _centred_window(win_length: int, n_fft: int) -> np.ndarray:
    """A periodic Hann of ``win_length`` centred in ``n_fft`` zeros
    (librosa ``util.pad_center``)."""
    full = np.zeros((n_fft,), np.float64)
    off = (n_fft - win_length) // 2
    full[off:off + win_length] = spectral.hann_window(win_length, periodic=True)
    return full


def stft_features(signal: torch.Tensor, cfg: FeatureConfig,
                  sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """librosa-style log1p STFT magnitude ``(..., T, n_fft//2+1)`` with
    ``T = 1 + S // hop``: frames centred by reflect padding of ``n_fft/2``,
    a periodic Hann of ``win_len`` samples padded to ``n_fft``, no
    pre-emphasis.

    The reflect-padded buffer is one gather: padded position ``p`` reads the
    sample at ``fold(p - n_fft/2, L)``, numpy's reflect fold with period
    ``2L - 2`` (exact over several folds). ``L`` is the row's true length
    where ``sample_lengths`` gives one, so a zero-padded row reflects
    around its own end and its first ``1 + L // hop`` frames equal the
    utterance's alone; else ``L`` is the batch width, which is
    ``np.pad(mode="reflect")``."""
    hop, pad = stft_hop(cfg), cfg.n_fft // 2
    width = signal.shape[-1]
    n_cols = 1 + width // hop
    need = (n_cols - 1 + -(-cfg.n_fft // hop)) * hop
    if sample_lengths is None:
        lengths = torch.full(signal.shape[:-1] + (1,), width, device=signal.device)
    else:
        lengths = torch.as_tensor(sample_lengths).to(signal.device).to(torch.int64)[..., None]
    pos = torch.arange(need, device=signal.device) - pad
    period = torch.clamp(2 * (lengths - 1), min=1)
    m = torch.remainder(pos, period)
    idx = torch.where(m >= lengths, period - m, m).clamp(0, width - 1)
    padded = torch.gather(signal, -1, idx.expand(*signal.shape[:-1], need))
    frames = framing.sliding_frames(padded, cfg.n_fft, hop, n_cols)
    frames = frames * _const(frames, _centred_window, int(cfg.rate * cfg.win_len), cfg.n_fft)
    re, im = _rdft(frames, cfg)
    return torch.log1p(torch.sqrt(re * re + im * im))


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
    CUDA tensor and runs the plain version on a CPU tensor; ``stft`` runs
    :func:`stft_features`.

    ``sample_lengths`` marks the true PCM length of each row of a
    zero-padded batch. The reference pre-emphasises the exact-length signal
    and pads after; so with lengths given (and ``cfg.preemph`` nonzero, as
    in the JAX package), the wrapper pre-emphasises and zeroes each row
    from its length on. The ``stft`` front-end never pre-emphasises; its
    lengths set where each row's reflect padding folds. CMVN and deltas
    over a padded batch would average
    pad-derived frames, so they are refused with lengths: apply a masked
    CMVN downstream (``train.audio.masked_cmvn``).
    """
    if sample_lengths is not None and (cfg.normalize or cfg.delta):
        raise ValueError(
            "sample_lengths with cfg.normalize/cfg.delta would compute "
            "CMVN/delta statistics over padding-derived frames; use "
            "normalize=False, delta=False and a masked CMVN over the valid "
            "frames instead (see train.audio.masked_cmvn)")
    _check_dft(cfg)
    if cfg.feat_type == "stft":
        feat = stft_features(signal, cfg, sample_lengths=sample_lengths)
    elif cfg.feat_type in MEL_FEATURES:
        from deeplip_tpu_torch.ops.cuda.fbank import audio_features

        lengths = None
        if sample_lengths is not None and cfg.preemph:
            lengths = torch.as_tensor(sample_lengths).to(signal.device)
            lengths = lengths.expand(signal.shape[:-1]).reshape(-1)
        flat = signal.reshape(-1, signal.shape[-1]).contiguous()
        feat = audio_features(flat, cfg, lengths)
        feat = feat.reshape(*signal.shape[:-1], *feat.shape[-2:])
    else:
        raise NotImplementedError(f"unknown feat_type {cfg.feat_type!r}")
    if cfg.normalize:
        feat = cmvn(feat)
    if cfg.delta:
        feat = add_deltas(feat, order=2)
    return feat
