"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``cuda``, and a host without a card raises instead of
carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return dev
