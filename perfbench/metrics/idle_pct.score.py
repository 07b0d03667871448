"""``idle_pct.score``: the share of the traced window in which no operation
ran on the card (the union of the trace's device operations)."""


def read(window):
    if window.busy_s is None or window.busy_s <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s / window.seconds)
