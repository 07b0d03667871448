"""Wrapper of the fused front-end kernel (``csrc/fbank_kernel.cu``).

:func:`audio_features` takes pre-emphasised, length-masked f32 PCM
``(B, S)`` and returns ``(B, T, D)`` fbank, logfbank or MFCC features: the
port of ``deeplip_tpu/ops/pallas/fbank_kernel.py``'s
``pallas_audio_features`` (its v2 and v1 Pallas kernels both). On a CUDA
tensor it launches the kernel on the current stream, or raises; on a CPU
tensor it runs the plain version, :func:`audio_features_reference`.

The kernel's constants (the f32 ``[cos | -sin]`` basis, the mel filterbank,
the DCT and the lifter) are uploaded once per device and config.
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


@lru_cache(maxsize=None)
def _kernel():
    fn = build.load("fbank_kernel").fbank_features
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _constants(device: torch.device, frame_len: int, n_fft: int, num_bin: int,
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
    return (l_pad,) + tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in arrays)


def out_dim(cfg: F.FeatureConfig) -> int:
    return cfg.num_cep if cfg.feat_type == "mfcc" else cfg.num_bin


def audio_features_reference(emph: torch.Tensor, cfg: F.FeatureConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the ``dft='matmul'`` front-end
    of ``ops.features`` on already pre-emphasised PCM."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    fn = {"mfcc": F.mfcc, "fbank": F.fbank, "logfbank": F.logfbank}[cfg.feat_type]
    return fn(emph, dataclasses.replace(cfg, preemph=0.0))


def audio_features(emph: torch.Tensor, cfg: F.FeatureConfig) -> torch.Tensor:
    """Fused front-end ``(B, S) -> (B, T, D)`` on pre-emphasised PCM
    (``cfg.preemph`` is not applied here). Counts its kernel launches in
    ``audio_features.launches``."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    if emph.device.type == "cpu":
        return audio_features_reference(emph, cfg)
    if emph.device.type != "cuda":
        raise ValueError(f"audio_features runs on cuda or cpu, not {emph.device}")
    if emph.dtype != torch.float32:
        raise TypeError(f"audio_features takes float32 PCM, got {emph.dtype}")
    if emph.ndim != 2 or not emph.is_contiguous():
        raise ValueError(
            f"audio_features takes a contiguous (B, S) batch, got shape "
            f"{tuple(emph.shape)} contiguous={emph.is_contiguous()}")
    b, s = emph.shape
    t = framing.num_frames(s, cfg.frame_len, cfg.frame_step)
    out = torch.empty((b, t, out_dim(cfg)), dtype=torch.float32,
                      device=emph.device)
    if b == 0:
        return out
    l_pad, basis, mel, dct, lift = _constants(
        emph.device, cfg.frame_len, cfg.n_fft, cfg.num_bin, cfg.rate,
        cfg.low_freq, cfg.high_freq, cfg.num_cep, cfg.ceplifter)
    with torch.cuda.device(emph.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            emph.data_ptr(), basis.data_ptr(), mel.data_ptr(), dct.data_ptr(),
            lift.data_ptr(), out.data_ptr(), b, s, t, cfg.frame_len, l_pad,
            cfg.frame_step, cfg.n_fft, cfg.num_bin, cfg.num_cep,
            _FEAT_CODES[cfg.feat_type], int(cfg.energy), stream)
    if err != 0:
        raise RuntimeError(f"fbank_features launch failed: cudaError_t {err}")
    audio_features.launches += 1
    return out


audio_features.launches = 0

