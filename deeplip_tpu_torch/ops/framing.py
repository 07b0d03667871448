"""Signal framing primitives (batched, on tensors).

Counterpart of ``deeplip_tpu/ops/framing.py``, with the conventions the
reference inherits from ``python_speech_features.sigproc``:

- ``frame_len = floor(win_len * rate + 0.5)`` (round-half-up),
- ``num_frames = 1 + ceil((slen - frame_len) / frame_step)`` for
  ``slen > frame_len`` else 1, with zero padding up to
  ``(num_frames - 1) * step + frame_len``,
- pre-emphasis ``y[t] = x[t] - 0.97 x[t-1]`` with ``y[0] = x[0]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def round_half_up(x: float) -> int:
    """Banker's-rounding-free round used by python_speech_features."""
    return int(math.floor(x + 0.5))


def frame_len_step(win_len: float, win_shift: float, rate: int) -> tuple[int, int]:
    """Window length / hop in samples from seconds (round-half-up)."""
    return round_half_up(win_len * rate), round_half_up(win_shift * rate)


def num_frames(n_samples: int, frame_len: int, frame_step: int) -> int:
    """Number of frames with the reference's round-up-and-pad convention."""
    if n_samples <= frame_len:
        return 1
    return 1 + int(math.ceil((n_samples - frame_len) / frame_step))


def samples_for_frames(n_frames: int, win_len: float, win_shift: float, rate: int) -> int:
    """Sample count that yields exactly ``n_frames`` frames
    (``duration = (frame - 1) * win_shift + win_len``)."""
    return int(((n_frames - 1) * win_shift + win_len) * rate)


def preemphasis(signal: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """First-order high-pass pre-emphasis along the last axis."""
    first = signal[..., :1]
    rest = signal[..., 1:] - coeff * signal[..., :-1]
    return torch.cat([first, rest], dim=-1)


def sliding_frames(
    signal: torch.Tensor, frame_len: int, frame_step: int, n_frames: int
) -> torch.Tensor:
    """``(..., S) -> (..., n_frames, frame_len)`` overlapping windows, zero
    padding (or truncating) the signal to exactly the samples they cover."""
    need = (n_frames - 1) * frame_step + frame_len
    pad = need - signal.shape[-1]
    if pad > 0:
        signal = F.pad(signal, (0, pad))
    elif pad < 0:
        signal = signal[..., :need]
    return signal.unfold(-1, frame_len, frame_step)


def frame_signal(signal: torch.Tensor, frame_len: int, frame_step: int) -> torch.Tensor:
    """Slice ``(..., S)`` into overlapping frames ``(..., T, frame_len)``
    with the zero-pad-to-cover convention of :func:`num_frames`."""
    t = num_frames(signal.shape[-1], frame_len, frame_step)
    return sliding_frames(signal, frame_len, frame_step, t)
