"""Wrappers of the fused front-end kernels: the FFT kernel
(``csrc/fbank_fft_kernel.cu``) and the DFT kernel (``csrc/fbank_kernel.cu``).

:func:`audio_features` takes raw f32 PCM ``(B, S)``, ``cfg.preemph`` and
optional per-row ``sample_lengths``, and returns ``(B, T, D)`` fbank,
logfbank or MFCC features: the port of ``deeplip_tpu/ops/pallas/
fbank_kernel.py``'s ``pallas_audio_features`` (its v2 and v1 Pallas kernels
both), with the pre-emphasis and the length mask of ``extract_features``
folded in. On a CUDA tensor it launches one kernel on the current stream,
or raises; on a CPU tensor it runs the plain version,
:func:`audio_features_reference`.

The rule between the kernels (:func:`uses_fft_kernel`): an ``n_fft`` that is
a power of two from 64 to 4096 goes to the FFT kernel, any other to the DFT
kernel. Both take every ``frame_len <= n_fft``.

The kernels' constants (FFT twiddles, the mel filterbank per filter, the
``[cos | -sin]`` basis, the DCT and the lifter) are made in float64 from
``ops.spectral``, cast to f32 and uploaded once per device and config.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops import framing, spectral
from deeplip_tpu_torch.ops.cuda import build

_FEAT_CODES = {"fbank": 0, "logfbank": 1, "mfcc": 2}
FFT_SIZES = (64, 4096)   # the FFT kernel's smallest and largest n_fft


def uses_fft_kernel(cfg: F.FeatureConfig) -> bool:
    """True when ``cfg.n_fft`` is a power of two in ``FFT_SIZES``: the FFT
    kernel's configs. Every other ``n_fft`` goes to the DFT kernel."""
    n = cfg.n_fft
    return FFT_SIZES[0] <= n <= FFT_SIZES[1] and n & (n - 1) == 0


# ------------------------------------------------ the FFT kernel's constants
def fft_plan(n_fft: int) -> list[tuple[int, int]]:
    """The kernel's passes over the ``n_fft/2``-point complex FFT, as
    ``(radix, ns)``: radix 16 while four or more factors of 2 are left, then
    one pass of the radix that is left (2, 4 or 8); ``ns`` is the size of
    the sub-transforms a pass combines."""
    n, plan, ns = n_fft // 2, [], 1
    while ns < n:
        radix = min(16, n // ns)
        plan.append((radix, ns))
        ns *= radix
    return plan


def _small_plan(radix: int) -> list[tuple[int, int]]:
    """The radix-4 (then radix-2) passes of the kernel's in-register
    ``radix``-point DFT, as ``(p, ns)``."""
    plan, ns = [], 1
    while ns < radix:
        p = 4 if radix // ns >= 4 else 2
        plan.append((p, ns))
        ns *= p
    return plan


def _w16_index(j: int, r: int, p: int, ns: int) -> int:
    """Which 16th root of unity the in-register DFT multiplies by."""
    return (j % ns) * r * (16 // (ns * p)) % 16


def fft_flops(n_fft: int) -> int:
    """Floating-point operations of the kernel's complex FFT of one frame:
    per pass, each butterfly's twiddle products (none in the first pass)
    and its in-register DFT (additions, and a product for every root of
    unity that is not 1, -1, i or -i)."""
    total = 0
    for i, (radix, _) in enumerate(fft_plan(n_fft)):
        dft = 0
        for p, ns in _small_plan(radix):
            q = radix // p
            dft += q * (16 if p == 4 else 4)
            dft += 6 * sum(_w16_index(j, r, p, ns) % 4 != 0
                           for j in range(q) for r in range(p))
        total += (n_fft // 2 // radix) * (dft + (6 * (radix - 1) if i else 0))
    return total


@lru_cache(maxsize=None)
def twiddles(n_fft: int) -> np.ndarray:
    """``exp(-2 pi i k / n_fft)`` for ``k < n_fft`` as ``(n_fft, 2)`` f32
    (re, im), computed in float64 and rounded once."""
    w = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@lru_cache(maxsize=None)
def mel_csr(n_filt: int, n_fft: int, rate: int, low_freq: float = 0.0,
            high_freq: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The f32 mel filterbank by filter: ``idx`` ``(3, n_filt)`` int32 rows
    of each filter's first nonzero bin, bin count and offset into
    ``weights``, the filters' weights from the first to the last nonzero
    bin, in order."""
    fb = spectral.mel_filterbank(n_filt, n_fft, rate, low_freq, high_freq)
    idx = np.zeros((3, n_filt), np.int32)
    weights = []
    for m in range(n_filt):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        idx[:, m] = lo, hi - lo, sum(len(w) for w in weights)
        weights.append(fb[lo:hi, m])
    return idx, np.concatenate(weights).astype(np.float32)


# ----------------------------------------------------------------- kernels
@lru_cache(maxsize=None)
def _fft_kernel():
    fn = build.load("fbank_fft_kernel").fbank_fft_features
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _dft_kernel():
    fn = build.load("fbank_kernel").fbank_features
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _upload(device: torch.device, *arrays) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@lru_cache(maxsize=None)
def _fft_constants(device: torch.device, n_fft: int, num_bin: int, rate: int,
                   low_freq: float, high_freq: float | None, num_cep: int,
                   ceplifter: int):
    """``(twiddles, mel idx, mel weights, dct, lift)`` on ``device``."""
    idx, weights = mel_csr(num_bin, n_fft, rate, low_freq, high_freq)
    return _upload(device, twiddles(n_fft), idx, weights,
                   spectral.dct_matrix(num_cep, num_bin).astype(np.float32),
                   spectral.cepstral_lifter(num_cep, ceplifter).astype(np.float32))


@lru_cache(maxsize=None)
def _dft_constants(device: torch.device, frame_len: int, n_fft: int, num_bin: int,
                   rate: int, low_freq: float, high_freq: float | None,
                   num_cep: int, ceplifter: int):
    """``(l_pad, basis, mel, dct, lift)`` on ``device``; the basis rows are
    zero-padded to ``l_pad``, a multiple of 4, for the kernel's float4 reads."""
    l_pad = -(-frame_len // 4) * 4
    basis = np.zeros((l_pad, 2 * (n_fft // 2 + 1)), np.float32)
    basis[:frame_len] = spectral.rdft_fused_matrix(frame_len, n_fft)
    arrays = (
        basis,
        spectral.mel_filterbank(num_bin, n_fft, rate, low_freq, high_freq),
        spectral.dct_matrix(num_cep, num_bin),
        spectral.cepstral_lifter(num_cep, ceplifter),
    )
    return (l_pad,) + _upload(device, *(a.astype(np.float32) for a in arrays))


def out_dim(cfg: F.FeatureConfig) -> int:
    return cfg.num_cep if cfg.feat_type == "mfcc" else cfg.num_bin


def _kernel_args(pcm: torch.Tensor, cfg: F.FeatureConfig, sample_lengths, what: str):
    """Check a batch for a kernel; ``(lengths or None, out)``."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    if pcm.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda, not {pcm.device}")
    if pcm.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 PCM, got {pcm.dtype}")
    if pcm.ndim != 2 or not pcm.is_contiguous():
        raise ValueError(
            f"{what} takes a contiguous (B, S) batch, got shape "
            f"{tuple(pcm.shape)} contiguous={pcm.is_contiguous()}")
    if cfg.frame_len > cfg.n_fft:
        raise ValueError(f"frame_len {cfg.frame_len} > n_fft {cfg.n_fft}")
    b, s = pcm.shape
    lengths = None
    if sample_lengths is not None:
        lengths = torch.as_tensor(sample_lengths).to(
            device=pcm.device, dtype=torch.int32).contiguous()
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"sample_lengths of shape {tuple(lengths.shape)} for {b} rows")
    t = framing.num_frames(s, cfg.frame_len, cfg.frame_step)
    out = torch.empty((b, t, out_dim(cfg)), dtype=torch.float32, device=pcm.device)
    return lengths, out


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def fft_audio_features(pcm: torch.Tensor, cfg: F.FeatureConfig,
                       sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The FFT kernel on a CUDA batch; raises for an ``n_fft`` it does not
    take. Counts its launches in ``fft_audio_features.launches``."""
    if not uses_fft_kernel(cfg):
        raise ValueError(f"the FFT kernel takes a power-of-two n_fft in "
                         f"[{FFT_SIZES[0]}, {FFT_SIZES[1]}], not {cfg.n_fft}")
    lengths, out = _kernel_args(pcm, cfg, sample_lengths, "fft_audio_features")
    (b, s), t = pcm.shape, out.shape[1]
    if b == 0:
        return out
    tw, idx, w, dct, lift = _fft_constants(
        pcm.device, cfg.n_fft, cfg.num_bin, cfg.rate, cfg.low_freq, cfg.high_freq,
        cfg.num_cep, cfg.ceplifter)
    with torch.cuda.device(pcm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fft_kernel()(
            pcm.data_ptr(), None if lengths is None else lengths.data_ptr(),
            tw.data_ptr(), idx.data_ptr(), w.data_ptr(), dct.data_ptr(),
            lift.data_ptr(), out.data_ptr(), b, s, t, cfg.frame_len, cfg.frame_step,
            cfg.n_fft, cfg.num_bin, cfg.num_cep, w.numel(), _FEAT_CODES[cfg.feat_type],
            int(cfg.energy), cfg.preemph, stream)
    _launched(err, "fbank_fft_features")
    fft_audio_features.launches += 1
    return out


def dft_audio_features(pcm: torch.Tensor, cfg: F.FeatureConfig,
                       sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The DFT kernel on a CUDA batch, at any ``n_fft``. Counts its
    launches in ``dft_audio_features.launches``."""
    lengths, out = _kernel_args(pcm, cfg, sample_lengths, "dft_audio_features")
    (b, s), t = pcm.shape, out.shape[1]
    if b == 0:
        return out
    l_pad, basis, mel, dct, lift = _dft_constants(
        pcm.device, cfg.frame_len, cfg.n_fft, cfg.num_bin, cfg.rate,
        cfg.low_freq, cfg.high_freq, cfg.num_cep, cfg.ceplifter)
    with torch.cuda.device(pcm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _dft_kernel()(
            pcm.data_ptr(), None if lengths is None else lengths.data_ptr(),
            basis.data_ptr(), mel.data_ptr(), dct.data_ptr(), lift.data_ptr(),
            out.data_ptr(), b, s, t, cfg.frame_len, l_pad, cfg.frame_step,
            cfg.n_fft, cfg.num_bin, cfg.num_cep, _FEAT_CODES[cfg.feat_type],
            int(cfg.energy), cfg.preemph, stream)
    _launched(err, "fbank_features")
    dft_audio_features.launches += 1
    return out


def audio_features_reference(pcm: torch.Tensor, cfg: F.FeatureConfig,
                             sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: pre-emphasis, then the mask at
    each row's length (the op order of ``extract_features`` in the JAX
    package), then the plain front-end of ``ops.features`` at ``cfg.dft``
    (``'matmul'`` unless the config asks for ``'fft'``)."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    signal = framing.preemphasis(pcm, cfg.preemph) if cfg.preemph else pcm
    if sample_lengths is not None:
        idx = torch.arange(signal.shape[-1], device=signal.device)
        mask = idx < torch.as_tensor(sample_lengths).to(signal.device)[..., None]
        signal = signal * mask.to(signal.dtype)
    fn = {"mfcc": F.mfcc, "fbank": F.fbank, "logfbank": F.logfbank}[cfg.feat_type]
    return fn(signal, dataclasses.replace(cfg, preemph=0.0))


def audio_features(pcm: torch.Tensor, cfg: F.FeatureConfig,
                   sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Fused front-end ``(B, S) -> (B, T, D)`` on raw PCM: pre-emphasis at
    ``cfg.preemph``, then, with ``sample_lengths``, zero from each row's
    length on. A CUDA batch goes to the kernel :func:`uses_fft_kernel`
    picks, which counts its own launches."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    if pcm.device.type == "cpu":
        return audio_features_reference(pcm, cfg, sample_lengths)
    if pcm.device.type != "cuda":
        raise ValueError(f"audio_features runs on cuda or cpu, not {pcm.device}")
    kernel = fft_audio_features if uses_fft_kernel(cfg) else dft_audio_features
    return kernel(pcm, cfg, sample_lengths)


fft_audio_features.launches = 0
dft_audio_features.launches = 0
