"""``ecapa_se_ms.train``: device milliseconds an ECAPA-TDNN train step's forward
spends in the program's ``deeplip.ecapa.se`` span (each SE-Res2Block's
squeeze-excitation gate, the gated product and the residual add; three spans a
step), summed over the traced window and divided by its units
(``_spans.per_unit``). None on a program without the span or where it ran on
no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.ecapa.se", "device_ms")
