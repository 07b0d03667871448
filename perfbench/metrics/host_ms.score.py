"""``host_ms.score``: host milliseconds a trial list spends inside the
program's ``deeplip.embed`` spans (its enqueue of the list's batches), summed
over the traced window and divided by its units (``_spans.per_unit``). None on
a program without the span."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.embed", "host_ms")
