"""Structured training metrics and profiling hooks.

Counterpart of ``deeplip_tpu/train/metrics.py``: :class:`StepLogger` writes
one JSON record per call (step, loss, accuracy, lr, steps/s, examples/s) to
``<exp_dir>/<prefix>_metrics.jsonl``, its float scalars to a TensorBoard
event file under ``<exp_dir>/tb/`` (``train.tb_events``), and prints every
``print_every`` steps; :class:`NanGuard` raises after ``patience``
non-finite losses in a row; :func:`profile_trace` wraps a region in a
``torch.profiler`` trace written as a Chrome trace, with the totals of the
port's spans (``core.spans``) beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time

import torch

from deeplip_tpu_torch.core import spans
from deeplip_tpu_torch.train.tb_events import TBEventWriter


class StepLogger:
    def __init__(self, exp_dir: str | None = None, print_every: int = 10,
                 prefix: str = "train", tensorboard: bool = True):
        self.print_every = print_every
        self.prefix = prefix
        self._file = None
        self._tb = None
        if exp_dir:
            os.makedirs(exp_dir, exist_ok=True)
            self._file = open(os.path.join(exp_dir, f"{prefix}_metrics.jsonl"), "a")
            if tensorboard:
                self._tb = TBEventWriter(os.path.join(exp_dir, "tb"))
        self._t0 = time.perf_counter()
        self._last_time = self._t0
        self._last_step = 0
        self._last_printed: int | None = None

    def log(self, step: int, examples: int | None = None, **scalars) -> None:
        now = time.perf_counter()
        record = {"step": step, "time": now - self._t0}
        dt = now - self._last_time
        if dt > 0 and step > self._last_step:
            record["steps_per_sec"] = (step - self._last_step) / dt
            if examples is not None:
                record["examples_per_sec"] = examples * (step - self._last_step) / dt
        record.update({k: float(v) for k, v in scalars.items()})
        self._last_time = now
        self._last_step = step
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb is not None:
            self._tb.add_scalars(step, {f"{self.prefix}/{k}": v for k, v in record.items()
                                        if k not in ("step", "time") and isinstance(v, float)})
        # a delta gate, not `step % print_every`: a caller that logs every
        # K steps would otherwise never hit the modulo
        if self.print_every and (self._last_printed is None
                                 or step - self._last_printed >= self.print_every):
            self._last_printed = step
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items() if k != "time")
            print(f"[{self.prefix}] {parts}", flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


class NanGuard:
    """Counts consecutive non-finite losses and raises after ``patience``."""

    def __init__(self, patience: int = 3):
        self.patience = patience
        self.streak = 0

    def check(self, loss: float) -> bool:
        """True if the step is usable; raises after ``patience`` bad steps."""
        if math.isfinite(loss):
            self.streak = 0
            return True
        self.streak += 1
        if self.streak >= self.patience:
            raise FloatingPointError(f"non-finite loss for {self.streak} consecutive steps")
        return False


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """A ``torch.profiler`` trace of the region (host, and the card's kernels
    where there is one), written into ``logdir`` as a Chrome trace
    (``trace.json``) in which the steps' spans (``deeplip.step``,
    ``deeplip.input``, ``deeplip.forward``, ``deeplip.backward``,
    ``deeplip.optimizer``, ``deeplip.embed``) are ranges, and their totals
    over the region by name (``core.spans.totals``) as ``spans.json``; a
    no-op when ``logdir`` is None."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    spans.reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as fh:
        json.dump(spans.totals(), fh, indent=1)
