"""``encode_audio_ms.train``: device milliseconds a fusion train step spends
in the program's ``deeplip.encode.audio`` span (the frozen E-TDNN's
x-vectors of the step's crops), summed over the traced window and divided
by its units (``_spans.per_unit``). None on a program without the span or
where it ran on no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.encode.audio", "device_ms")
