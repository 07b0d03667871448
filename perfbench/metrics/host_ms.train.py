"""``host_ms.train``: host milliseconds a train step spends inside the
program's ``deeplip.step`` span (its enqueue of the step), summed over the
traced window and divided by its units (``_spans.per_unit``). None on a
program without the span."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.step", "host_ms")
