"""``k1_roofline``: the front-end's least time over its device time. The
least time of each batch is the larger of its operations over the FP32 peak
and its bytes over the HBM peak (``_work.front_end_work`` at the batch's
shape); the device time sums the trace's launches of these kernels:"""

from perfbench.metrics import _work

KERNELS = ("fbank_fft_kernel", "fbank_mixed_fft_kernel", "fbank_features_kernel")


def read(window):
    peak = _work.peaks(window.device_name)
    _, seconds = _work.kernel_seconds(window.kernels, KERNELS)
    if peak is None or seconds <= 0:
        return None
    feat = window.work["feat"]
    bound = sum(n * _work.bound_s(_work.front_end_work(b, s, feat), peak)
                for b, s, n in window.work["k1_batches"])
    return 100.0 * bound / seconds
