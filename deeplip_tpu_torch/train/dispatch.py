"""Grouped train-step dispatch: K train steps as one captured CUDA graph.

Counterpart of the JAX package's grouped dispatch, where K steps are one
device program (``lax.scan`` in ``AudioTrainer._train_step_group`` and
``VideoTrainer._train_step_group``). On the card the counterpart of that
program is a CUDA graph: :class:`GroupedSteps` captures one graph per
(input shapes, dtypes, K) that runs K steps in a row, and replays it once
per group. The hand-written kernels on the path (K1 in the audio step,
K3/K4 and the frontend max-pool in the video step) are captured with the
rest and replayed: their wrappers launch on ``torch.cuda.current_stream()``,
which inside ``torch.cuda.graph`` is the capture stream, and on the train
path none of them reads a value on the host or allocates pinned memory.

- Static buffers hold the group's ``(K, B, ...)`` inputs and its per-step
  scalars (the learning rate of each step, the margin), and are filled by
  copies before every replay: a value a graph read as a Python number
  would stay the one it saw at capture.
- Before a capture, one eager warm-up step runs on a side stream: it builds
  the kernels, uploads K1's cached constants and lets cuDNN and cuBLAS set
  up. The trainable state (parameters, buffers, optimizer state) and the
  card's random-number state are saved before it and written back after
  it, so the warm-up leaves no trace in the run. The optimizer's state is
  made before the save, so the capture finds every tensor it updates.
- Every graph of a runner draws on one memory pool. That is safe because
  the graphs never run at the same time (each replays on the trainer's
  stream, one after another) and no graph reads another's temporaries: the
  state they share lives outside the pool. A private pool per graph would
  keep each graph's peak resident at once: the f32 video step alone peaks
  at tens of GB and the audio trainer captures up to one graph per crop
  length.
- A graph keeps the addresses of the state tensors it was captured with;
  a state that was replaced (an optimizer's ``load_state_dict``) makes the
  runner capture again.
- The kernels' wrappers count launches when they are called, so a capture
  moves the counts once and a replay not at all. The runner takes back
  what a capture added and adds it again on every replay, so ``.launches``
  counts the kernels that ran.
- A capture that fails raises: there is no eager fallback on the card. On
  the CPU, :meth:`GroupedSteps.run` runs the K steps eagerly, one after
  another, so the grouping can be tested there.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import torch

from deeplip_tpu_torch.ops.cuda import bn_prelu, fbank, maxpool

# (object, attribute) of every kernel launch count a train step can move
KERNEL_COUNTERS = (
    (fbank.fft_audio_features, "launches"), (fbank.dft_audio_features, "launches"),
    (bn_prelu.bn_prelu_forward, "launches"), (bn_prelu.bn_prelu_backward, "launches"),
    (maxpool.maxpool_forward, "launches"), (maxpool.maxpool_backward, "launches"))

Body = Callable[[int, Mapping[str, torch.Tensor], Mapping[str, torch.Tensor]],
                Mapping[str, torch.Tensor]]


@dataclass
class _Captured:
    graph: object
    inputs: dict
    scalars: dict
    outputs: dict
    state_ptrs: list
    launches: list = field(default_factory=list)   # counter moves per replay
    replays: int = 0


class GroupedSteps:
    """Runs ``body`` for steps ``0..K-1`` of a group, as one captured graph
    on the card.

    ``body(i, inputs, scalars)`` runs step ``i`` of a group from
    ``inputs[name][i]`` and ``scalars[name][i]`` and returns its 0-d
    metrics (``loss``, ``acc``); it must not read Python numbers that change
    from group to group. ``state()`` returns every tensor a step updates in
    place (parameters, buffers, optimizer state); ``prepare()`` is called
    before it is read for a capture (it makes the optimizer's state).
    """

    def __init__(self, body: Body, state: Callable[[], Sequence[torch.Tensor]],
                 device: torch.device, prepare: Callable[[], None] = lambda: None,
                 counters: Sequence[tuple[object, str]] = KERNEL_COUNTERS):
        self.body, self.state, self.prepare = body, state, prepare
        self.device = torch.device(device)
        self.counters = counters
        self.captures = self.device.type == "cuda"
        self.graphs: dict[tuple, _Captured] = {}
        self.warmup_steps = 0
        self._pool = torch.cuda.graph_pool_handle() if self.captures else None

    # ------------------------------------------------------------------
    def run(self, inputs: Mapping[str, torch.Tensor],
            scalars: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One group: ``inputs`` are ``(K, ...)`` tensors on the device,
        ``scalars`` ``(K,)`` (or ``(1,)``) tensors on the host. Returns each
        metric as a ``(K,)`` tensor on the device."""
        k = next(iter(inputs.values())).shape[0]
        if not self.captures:
            scalars = {n: s.to(self.device) for n, s in scalars.items()}
            return self._steps(k, inputs, scalars)
        key = tuple((n, tuple(t.shape), t.dtype) for n, t in
                    sorted({**inputs, **scalars}.items()))
        entry = self.graphs.get(key)
        if entry is None or entry.state_ptrs != self._state_ptrs():
            entry = self.graphs[key] = self._capture(k, inputs, scalars)
        else:
            self._fill(entry, inputs, scalars)
        entry.graph.replay()
        entry.replays += 1
        for (obj, attr), moved in zip(self.counters, entry.launches):
            setattr(obj, attr, getattr(obj, attr) + moved)
        return {n: t.clone() for n, t in entry.outputs.items()}

    def _steps(self, k: int, inputs, scalars) -> dict[str, torch.Tensor]:
        metrics = [self.body(i, inputs, scalars) for i in range(k)]
        return {n: torch.stack([m[n] for m in metrics]) for n in metrics[0]}

    def _state_ptrs(self) -> list:
        return [t.data_ptr() for t in self.state()]

    @staticmethod
    def _fill(entry: _Captured, inputs, scalars) -> None:
        for n, t in inputs.items():
            entry.inputs[n].copy_(t, non_blocking=True)
        for n, t in scalars.items():
            entry.scalars[n].copy_(t, non_blocking=True)

    def _counts(self) -> list:
        return [getattr(obj, attr) for obj, attr in self.counters]

    def _capture(self, k: int, inputs, scalars) -> _Captured:
        static_in = {n: torch.empty_like(t, device=self.device) for n, t in inputs.items()}
        static_sc = {n: torch.empty_like(t, device=self.device) for n, t in scalars.items()}
        entry = _Captured(None, static_in, static_sc, {}, [])
        self._fill(entry, inputs, scalars)
        self._warm_up(static_in, static_sc)
        before = self._counts()
        entry.graph, entry.outputs = self._graph_capture(
            lambda: self._steps(k, static_in, static_sc))
        entry.launches = [a - b for a, b in zip(self._counts(), before)]
        for (obj, attr), count in zip(self.counters, before):
            setattr(obj, attr, count)
        entry.state_ptrs = self._state_ptrs()
        return entry

    def _warm_up(self, inputs, scalars) -> None:
        """Step 0 eagerly on a side stream, with the state and the card's
        random-number state written back after it."""
        self.prepare()
        state = list(self.state())
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        rng = torch.cuda.get_rng_state(self.device) if self.device.type == "cuda" else None
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            self.body(0, inputs, scalars)
        if side is not None:
            torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        del saved
        if rng is not None:
            torch.cuda.set_rng_state(rng, self.device)
            # the memory the eager step cached goes back to the card, so the
            # capture's pool can take it (a step's peak twice over does not
            # fit beside the f32 video step)
            torch.cuda.empty_cache()
        self.warmup_steps += 1

    def _graph_capture(self, fn):
        """``(graph, outputs)``: ``fn`` captured into a CUDA graph on this
        runner's pool. A capture that fails raises, and leaves the card's
        random-number generator as it found it."""
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the loader threads may touch the CUDA runtime
            # while this thread captures; only this thread's calls must be
            # capture-safe
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = fn()
        except Exception:
            self._end_generator_capture()
            raise
        return graph, outputs

    def _end_generator_capture(self) -> None:
        """torch marks the card's generator as capturing when a capture
        begins and clears the mark only when a capture ends cleanly; after a
        failed one, the next eager dropout raises. One capture of a single
        op that ends cleanly clears it."""
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            torch.zeros(1, device=self.device)
