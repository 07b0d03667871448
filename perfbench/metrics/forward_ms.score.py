"""``forward_ms.score``: device milliseconds a trial list spends in the
program's ``deeplip.forward`` spans (the E-TDNN embedding and its L2 norm),
summed over the traced window and divided by its units (``_spans.per_unit``).
None on a program without the span or where it ran on no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.forward", "device_ms")
