"""``backward_ms.train``: device milliseconds a train step spends in the
program's ``deeplip.backward`` span (the backward and the gradients'
reduction), summed over the traced window and divided by its units
(``_spans.per_unit``). None on a program without the span or where it ran on
no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.backward", "device_ms")
