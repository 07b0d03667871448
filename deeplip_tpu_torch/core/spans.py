"""Named ranges over the phases of the port's train steps and embedding
batches, for a profiler's operator.

:func:`span` marks one phase. While no profiler follows the calling thread
(``torch.profiler.profile``, the autograd profiler or ``emit_nvtx``:
``torch.autograd._profiler_enabled()`` is false) it returns one shared no-op
context: one check, no allocation, no ``record_function``. While one does,
the span opens ``record_function(name)``, so the range sits, nested, in the
profiler's trace on the device trace's clock, and adds itself to a registry
of totals by name:

- ``count``, and ``host_ms``: host time inside the span;
- ``self_host_ms``: that time less the part its child spans cover;
- ``device_ms``: stream time between two CUDA events recorded on the current
  stream where the span starts and ends: its kernels plus any wait for the
  host inside it. None for a name that never ran on a card. No event is
  recorded while the stream is being captured into a CUDA graph, so a
  graph's replays carry no spans.

The totals build up over the process while a profiler runs; :func:`reset`
clears them and :func:`totals` reads them, waiting for the pending events.
Completed events are folded in once :data:`FOLD_AT` are pending, so a
profiler left on for hours holds bounded memory.

The names, and what each covers:

- ``deeplip.step``: one optimizer step at a single-step entry of the
  trainers (``train_step``, ``train_step_frames``, ``train_step_feats``,
  ``head_step``);
- ``deeplip.input``: the step's input transform (the video crops and flips,
  the audio rescale and front-end; a fusion step's front-end with its CMVN,
  and its clips' eval transform and pad masks), or an embedding batch's
  front-end, CMVN and deltas;
- ``deeplip.encode.audio``: a fusion step's frozen audio encoder (the
  x-vectors of its crops);
- ``deeplip.encode.video``: a fusion step's frozen video encoder (the frame
  path, each clip's time mean and each item's clip-group mean);
- ``deeplip.forward``: the model's forward with the loss and accuracy (a
  fusion step's head and criterion), or the embedding and its
  normalisation;
- ``deeplip.backward``: the backward and the gradients' reduction over the
  ranks;
- ``deeplip.optimizer``: the optimizer's update;
- ``deeplip.embed``: one ``AudioExtractor.embed`` call;
- ``deeplip.ecapa.res2net``: inside an ECAPA-TDNN forward
  (``models/ecapa.py``), one SE-Res2Block's split, its chain of dilated
  convolutions, the adds between them and the concatenation;
- ``deeplip.ecapa.se``: one SE-Res2Block's squeeze-excitation gate, the
  gated product and the residual add;
- ``deeplip.ecapa.pool``: the multi-layer aggregation, the attentive
  statistics pooling, its BN and the FC + BN head. Their backward stays
  whole in ``deeplip.backward``.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

NAMES = frozenset({"deeplip.step", "deeplip.input", "deeplip.encode.audio",
                   "deeplip.encode.video", "deeplip.forward", "deeplip.backward",
                   "deeplip.optimizer", "deeplip.embed", "deeplip.ecapa.res2net",
                   "deeplip.ecapa.se", "deeplip.ecapa.pool"})
FOLD_AT = 4096   # pending event pairs at which the completed ones are folded in

OFF = contextlib.nullcontext()   # the span while no profiler runs

_profiler_enabled = torch.autograd._profiler_enabled
_local = threading.local()


class Registry:
    """Totals of the spans by name; one lock guards them, since spans may
    close on several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: dict[str, list] = {}   # name -> [count, host ns, self ns, device ms]
        self._pending: list = []             # (name, start event, end event)

    def add(self, name: str, host_ns: int, self_ns: int, events) -> None:
        with self._lock:
            entry = self._totals.setdefault(name, [0, 0, 0, None])
            entry[0] += 1
            entry[1] += host_ns
            entry[2] += self_ns
            if events is not None:
                if entry[3] is None:
                    entry[3] = 0.0
                self._pending.append((name, *events))
                if len(self._pending) >= FOLD_AT:
                    self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        kept = []
        for name, start, end in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                kept.append((name, start, end))
                continue
            self._totals[name][3] += start.elapsed_time(end)
        self._pending = kept

    def totals(self) -> dict:
        """``{name: {count, host_ms, self_host_ms, device_ms}}``."""
        with self._lock:
            self._fold(wait=True)
            return {name: {"count": n, "host_ms": host / 1e6, "self_host_ms": own / 1e6,
                           "device_ms": device}
                    for name, (n, host, own, device) in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self._totals, self._pending = {}, []


REGISTRY = Registry()
totals = REGISTRY.totals
reset = REGISTRY.reset


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "range", "events", "start", "children")

    def __init__(self, name: str, device):
        if name not in NAMES:
            raise ValueError(f"unknown span {name!r}; the spans are {sorted(NAMES)}")
        self.name, self.device = name, device

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.events = None
        if (self.device is not None and self.device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.children = 0
        _stack().append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter_ns() - self.start
        if self.events is not None:
            self.events[1].record()
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].children += host
        REGISTRY.add(self.name, host, host - self.children, self.events)
        self.range.__exit__(*exc)
        return False


def span(name: str, device: torch.device | None = None):
    """The range ``name`` (one of :data:`NAMES`) over a block whose work runs
    on ``device``; CUDA events time it on the card where ``device`` is one.
    The shared no-op :data:`OFF` while no profiler runs."""
    if not _profiler_enabled():
        return OFF
    return _Span(name, device)
