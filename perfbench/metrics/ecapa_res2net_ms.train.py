"""``ecapa_res2net_ms.train``: device milliseconds an ECAPA-TDNN train step's
forward spends in the program's ``deeplip.ecapa.res2net`` span (each SE-
Res2Block's split, its chain of seven dilated 128-wide TDNNs, the adds between
them and the concatenation; three spans a step), summed over the traced window
and divided by its units (``_spans.per_unit``). None on a program without the
span or where it ran on no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.ecapa.res2net", "device_ms")
