"""Spectral transform matrices: DFT, mel filterbank, DCT, liftering (numpy).

A copy of ``deeplip_tpu/ops/spectral.py``'s arrays, which must stay
byte-equal to the JAX package's (``tests/test_torch_features.py`` holds
them so). Conventions of the reference's DSP libraries:

- mel scale ``2595 log10(1 + hz/700)`` with filterbank bin edges
  ``floor((nfft + 1) * hz / rate)`` (python_speech_features convention),
- DCT-II with 'ortho' norm for MFCC,
- cepstral lifter ``1 + (L/2) sin(pi n / L)``,
- periodic Hann window for the librosa-style STFT path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def rdft_matrices(frame_len: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases: ``(frame_len, n_fft//2+1)`` cos and -sin matrices.

    ``frames @ cos_mat + 1j * frames @ sin_mat == rfft(frames, n_fft)`` for
    frames of length ``frame_len <= n_fft`` (implicit zero-padding to n_fft).
    """
    if frame_len > n_fft:
        raise ValueError(f"frame_len {frame_len} > n_fft {n_fft}")
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(frame_len)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float64), (-np.sin(ang)).astype(np.float64)


@lru_cache(maxsize=None)
def rdft_fused_matrix(frame_len: int, n_fft: int) -> np.ndarray:
    """Column-concatenated rDFT basis ``[cos | -sin]``, ``(frame_len, 2K)``."""
    cos_m, sin_m = rdft_matrices(frame_len, n_fft)
    return np.concatenate([cos_m, sin_m], axis=1)


@lru_cache(maxsize=None)
def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches librosa/scipy ``fftbins=True``."""
    denom = win_length if periodic else win_length - 1
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(np.float64)


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def mel_filterbank(
    n_filt: int,
    n_fft: int,
    rate: int,
    low_freq: float = 0.0,
    high_freq: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_fft//2+1, n_filt)``, with the
    python_speech_features edge convention: filter corner bins are
    ``floor((n_fft + 1) * hz / rate)``."""
    high_freq = high_freq or rate / 2.0
    mel_points = np.linspace(hz_to_mel(low_freq), hz_to_mel(high_freq), n_filt + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mel_points) / rate).astype(np.int64)
    fb = np.zeros((n_filt, n_fft // 2 + 1), dtype=np.float64)
    for j in range(n_filt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb.T.copy()


@lru_cache(maxsize=None)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix of shape ``(n_in, n_out)``:
    ``log_mel @ dct_matrix(numcep, nfilt)`` equals
    ``scipy.fftpack.dct(log_mel, type=2, norm='ortho')[..., :numcep]``."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n + 1) / (2.0 * n_in))
    scale = np.full((1, n_out), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return (mat * scale).astype(np.float64)


@lru_cache(maxsize=None)
def cepstral_lifter(n_cep: int, lifter: int = 22) -> np.ndarray:
    """Sinusoidal lifter weights ``1 + (L/2) sin(pi n / L)``, shape (n_cep,)."""
    if lifter <= 0:
        return np.ones((n_cep,), dtype=np.float64)
    n = np.arange(n_cep)
    return (1.0 + (lifter / 2.0) * np.sin(np.pi * n / lifter)).astype(np.float64)
