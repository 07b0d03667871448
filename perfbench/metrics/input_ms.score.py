"""``input_ms.score``: device milliseconds a trial list spends in the
program's ``deeplip.input`` spans (int16 rescale, K1, length masks, masked
CMVN), summed over the traced window and divided by its units
(``_spans.per_unit``). None on a program without the span or where it ran on
no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.input", "device_ms")
