"""Device resolution and the FP32 pin for the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``cuda``, and a host without a card raises instead of
carrying on on the CPU.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return dev


_fp32_lock = threading.Lock()
_fp32_depth = 0
_fp32_saved = (False, True)


@contextlib.contextmanager
def fp32_math():
    """Full-FP32 matmuls and cuDNN convolutions (no TF32) inside the block;
    cuDNN's ``benchmark`` and ``deterministic`` settings stay the caller's.

    The switches are process-wide, so blocks entered from several threads
    (a serving collector beside direct calls) are counted: the first one in
    saves and clears them, the last one out restores them, and no thread
    computes under TF32 because another has left its block."""
    global _fp32_depth, _fp32_saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = False
            cudnn.allow_tf32 = False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _fp32_saved
