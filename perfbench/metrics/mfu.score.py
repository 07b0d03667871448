"""``mfu.score``: the FLOPs of the window's trial lists (FlopCounterMode over
one list at set-up, ``_work.counted_flops``) over the traced window's
seconds, as a share of the card's peak for the path's type: FP32 on the
CUDA cores (67 TFLOP/s on the SXM part), since the extraction runs with
TF32 off."""

from perfbench.metrics import _work


def read(window):
    peak = _work.peaks(window.device_name)
    if peak is None or not window.work.get("flops"):
        return None
    return 100.0 * window.work["flops"] / window.seconds / peak[window.work["peak"]]
