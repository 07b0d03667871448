"""The program's span totals (``deeplip_tpu_torch/core/spans.py``), read once
the window has closed, per unit of the window (a train step, a trial list).

The program adds to them only while a profiler runs, which in a run of the
benchmark is the traced window alone. A program without spans, a span that
did not run, and device time of a span that ran on no card give None.
"""

import importlib


def per_unit(window, name: str, key: str):
    """``key`` (``host_ms``, ``device_ms``) of the span ``name`` over the
    window's units, or None."""
    try:
        spans = importlib.import_module("deeplip_tpu_torch.core.spans")
    except ImportError:
        return None
    entry = spans.totals().get(name)
    if entry is None or entry[key] is None or not window.units:
        return None
    return entry[key] / window.units
