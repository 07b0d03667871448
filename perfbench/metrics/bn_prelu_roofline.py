"""``bn_prelu_roofline``: the fused train-mode BN+PReLU's least time (K3
forward and K4 backward at each of a step's sites, ``_work.bn_bound_s``)
over the device time of these kernels in the trace:"""

from perfbench.metrics import _work

KERNELS = ("stats_partial_kernel", "stats_finalize_kernel", "stats_totals_kernel",
           "stats_from_totals_kernel", "apply_kernel",
           "bwd_partial_kernel", "bwd_finalize_kernel", "bwd_totals_kernel",
           "bwd_from_totals_kernel", "bwd_apply_kernel")


def read(window):
    peak = _work.peaks(window.device_name)
    _, seconds = _work.kernel_seconds(window.kernels, KERNELS)
    if peak is None or seconds <= 0 or not window.work.get("bn_sites"):
        return None
    bound = window.work["steps"] * _work.bn_step_bound_s(window.work["bn_sites"],
                                                         window.work["itemsize"], peak)
    return 100.0 * bound / seconds
