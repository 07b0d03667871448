"""``input_ms.train``: device milliseconds a train step spends in the
program's ``deeplip.input`` span (the video crops, flips and transform; the
audio rescale and K1), summed over the traced window and divided by its units
(``_spans.per_unit``). None on a program without the span or where it ran on
no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.input", "device_ms")
