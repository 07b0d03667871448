"""``encode_video_ms.train``: device milliseconds a fusion train step spends
in the program's ``deeplip.encode.video`` span (the frozen Lipreading frame
path over every clip slot, each clip's time mean and each item's group
mean), summed over the traced window and divided by its units
(``_spans.per_unit``). None on a program without the span or where it ran
on no card."""

from perfbench.metrics import _spans


def read(window):
    return _spans.per_unit(window, "deeplip.encode.video", "device_ms")
