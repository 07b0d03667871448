"""``step_ms_p95.train``: the 95th percentile of the device time of a train
step, from the CUDA events recorded around every step of the traced window
(the benchmark's own events; read once the window has closed)."""

import statistics


def read(window):
    if len(window.step_ms) < 2:
        return None
    return statistics.quantiles(window.step_ms, n=20)[18]
