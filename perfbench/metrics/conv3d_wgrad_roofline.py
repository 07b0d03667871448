"""``conv3d_wgrad_roofline``: the least time of the Lipreading frontend
Conv3d's weight gradient in an f32 step, ``2 * C * 245 * B * T * Ho * Wo``
FP32 operations at the card's FP32 peak (``pool_shape`` is the conv's
output, ``(B, T, Ho, Wo, C)``), over the device time of the kernel that
computes it, both its passes, in the trace. None for a bf16 step, whose
weight gradient is cuDNN's, and where the trace holds neither pass."""

from perfbench.metrics import _work

KERNELS = ("conv3d_wgrad_kernel", "conv3d_wgrad_sum_kernel")
TAPS = 5 * 7 * 7


def read(window):
    peak = _work.peaks(window.device_name)
    _, seconds = _work.kernel_seconds(window.kernels, KERNELS)
    shape = window.work.get("pool_shape")
    if peak is None or seconds <= 0 or not shape or window.work.get("itemsize") != 4:
        return None
    b, t, ho, wo, c = shape
    least = 2.0 * c * TAPS * b * t * ho * wo / peak["fp32"]
    return 100.0 * window.work["steps"] * least / seconds
