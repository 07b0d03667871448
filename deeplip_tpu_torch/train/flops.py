"""FLOP accounting and MFU (model FLOPs utilisation) reporting.

Counterpart of ``deeplip_tpu/train/flops.py``. The FLOPs of a step come
from ``torch.utils.flop_counter.FlopCounterMode`` run over one eager call
(:func:`counted_flops`): PyTorch's count of the matrix products and
convolutions the step dispatches, forward and backward. Work done inside
the port's own CUDA kernels (the front-end) and elementwise passes is not
counted, so MFU errs low, the side the JAX package errs on too.

The peaks are NVIDIA's data-sheet numbers for the H100's SXM, PCIe and NVL
parts, dense (no sparsity), at each part's full power limit: FP32 on the
CUDA cores, TF32 and bf16 on the tensor cores, HBM bytes/s. MFU is against
the dense bf16 peak. Another card, or the CPU, has no entry, and MFU is
then left out rather than invented.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

H100_PEAKS: dict[str, dict[str, float]] = {
    "sxm": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12},
    "pcie": {"fp32": 51e12, "tf32": 378e12, "bf16": 756e12, "hbm": 2.0e12},
    "nvl": {"fp32": 60e12, "tf32": 418e12, "bf16": 835e12, "hbm": 3.9e12},
}


def h100_part(name: str) -> str | None:
    """The H100 part a device name names (``torch.cuda.get_device_name``,
    e.g. "NVIDIA H100 80GB HBM3" for the SXM part), or None for another
    card."""
    if "H100" not in name:
        return None
    return "pcie" if "PCIe" in name else "nvl" if "NVL" in name else "sxm"


def peak_flops_per_sec(device: Any = None) -> float | None:
    """Dense bf16 peak of ``device`` (default: the first card, if any);
    None on the CPU and on a card that is not an H100."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    part = h100_part(torch.cuda.get_device_name(device))
    return H100_PEAKS[part]["bf16"] if part else None


def counted_flops(fn: Callable, *args, **kwargs) -> float | None:
    """FLOPs of one eager call of ``fn(*args, **kwargs)``, as
    ``FlopCounterMode`` counts them. The call runs (a train step takes its
    step), so give it state it may change. Never inside a graph capture.
    None when nothing was counted."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def mfu_fields(flops_per_step: float | None, steps_per_sec: float,
               n_devices: int = 1, device: Any = None) -> dict:
    """The efficiency fields of a result line: ``tflops_per_sec`` (achieved,
    per card) and ``mfu`` (against the dense bf16 peak). Empty when the
    FLOPs are unknown, ``mfu`` left out when the peak is."""
    if not flops_per_step or steps_per_sec <= 0:
        return {}
    achieved = flops_per_step * steps_per_sec / max(n_devices, 1)
    out = {"tflops_per_sec": round(achieved / 1e12, 2)}
    peak = peak_flops_per_sec(device)
    if peak:
        out["mfu"] = round(achieved / peak, 4)
    return out
