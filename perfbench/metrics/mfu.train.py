"""``mfu.train``: the FLOPs of the window's train steps (FlopCounterMode over
one step of each shape at set-up, ``_work.counted_flops``) over the traced window's
seconds, as a share of the card's peak for the step's type: bf16 (989
TFLOP/s dense on the SXM part) for a bf16 step, FP32 (67 TFLOP/s) for an
f32 step, which runs with TF32 off."""

from perfbench.metrics import _work


def read(window):
    peak = _work.peaks(window.device_name)
    if peak is None or not window.work.get("flops"):
        return None
    return 100.0 * window.work["flops"] / window.seconds / peak[window.work["peak"]]
