"""``bn_prelu_eval_ms.train``: device milliseconds a train step spends in the
ResNet trunk's one-pass BN + PReLU eval kernel (the frozen video encoder of
a fusion step), its device time by name in the trace over the window's
units; None where the trace holds none of it (a program without the
kernel, or a step that never runs the trunk in eval mode)."""

from perfbench.metrics import _work

KERNELS = ("bn_prelu_eval_kernel",)


def read(window):
    _, seconds = _work.kernel_seconds(window.kernels, KERNELS)
    if seconds <= 0 or not window.units:
        return None
    return 1000.0 * seconds / window.units
