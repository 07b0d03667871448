"""``maxpool_roofline``: the frontend max-pool's least time, forward and
backward at the step's shape (``_work.pool_bounds_s``: the bytes each pass
must move), over the device time of these kernels in the trace:"""

from perfbench.metrics import _work

KERNELS = ("maxpool_fwd_kernel", "maxpool_bwd_kernel")


def read(window):
    peak = _work.peaks(window.device_name)
    _, seconds = _work.kernel_seconds(window.kernels, KERNELS)
    if peak is None or seconds <= 0 or not window.work.get("pool_shape"):
        return None
    b = _work.pool_bounds_s(window.work["pool_shape"], window.work["itemsize"], peak)
    return 100.0 * window.work["steps"] * (b["fwd"] + b["bwd"]) / seconds
