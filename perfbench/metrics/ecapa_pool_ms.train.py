"""``ecapa_pool_ms.train``: device milliseconds an ECAPA-TDNN train step's
forward spends in the program's ``deeplip.ecapa.pool`` span (the multi-layer
aggregation, the attentive statistics pooling with global context, its BN and
the FC + BN head; one span a step), summed over the traced window and divided
by its units (``_spans.per_unit``). None on a program without the span or
where it ran on no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.ecapa.pool", "device_ms")
