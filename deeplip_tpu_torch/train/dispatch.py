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
- Before a capture, the group's K steps run eagerly on a side stream, as
  its warm-up and its reference: they build the kernels, upload K1's
  cached constants and let cuDNN and cuBLAS set up. The trainable state
  (parameters, buffers, optimizer state) and the card's random-number
  state are saved before them and written back after them, so the warm-up
  leaves no trace in the run; their metrics and final state are kept for
  the first replay's check (below). Both copies of the state are kept on
  the host, so that the capture has the card's memory of the steps alone.
  The optimizer's state is made before the save, so the capture finds
  every tensor it updates.
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
- The kernels' launches are counted when their wrappers are called
  (``ops.cuda.launch_counts``), so a capture moves the counts once and a
  replay not at all. The runner reads the counts before and after a
  capture, puts them back to the first reading, and adds the difference on
  every replay, so the counts are of the kernels that ran.
- A capture that fails raises: there is no eager fallback on the card. On
  the CPU, :meth:`GroupedSteps.run` runs the K steps eagerly, one after
  another, so the grouping can be tested there.
- A graph must compute what the eager steps compute. When a cuDNN
  workspace cannot be allocated, PyTorch quietly runs the convolution with
  another algorithm and keeps that plan for the shape, so a warm-up or
  capture short of memory can record a graph that computes other numbers
  than the eager steps before it. The runner refuses such a graph: it
  raises, keeping no graph and with the state and the random-number state
  as they were before the group, (a) when any allocation failed during its
  warm-up, capture or first replay (the allocator's ``num_ooms`` moved, or
  the card ran out of memory there), and (b) where cuDNN runs
  deterministic (``torch.backends.cudnn.deterministic`` or
  ``torch.use_deterministic_algorithms``), when the first replay's metrics
  or final state are not bit-equal to the K eager steps' from the same
  state. With cuDNN's nondeterministic algorithms allowed (the default)
  the two may differ by those algorithms' own rounding, so only (a)
  holds. The warm-up, the capture and the replays run on the caller's
  thread, whose cached plans the eager steps chose: cuDNN keeps its plans
  per thread, and a thread of their own would choose anew, by the caching
  allocator's state of the moment.
- A runner holds the bound methods it is given (a trainer's step body and
  state) through weak references. A trainer owns its runner, so the pair
  forms no reference cycle: a trainer that is dropped frees its runner,
  its graphs and their memory pool at once, without the cycle collector.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import torch

from deeplip_tpu_torch.ops.cuda import build, launch_counts

Body = Callable[[int, Mapping[str, torch.Tensor], Mapping[str, torch.Tensor]],
                Mapping[str, torch.Tensor]]


def weak_callable(fn: Callable) -> Callable:
    """``fn``, held through a weak reference to its object when it is a
    bound method; calling it after the object died raises ReferenceError."""
    if not hasattr(fn, "__self__") or not hasattr(fn, "__func__"):
        return fn
    ref = weakref.WeakMethod(fn)

    def call(*args, **kwargs):
        method = ref()
        if method is None:
            raise ReferenceError("the object that owned this grouped step is gone")
        return method(*args, **kwargs)
    return call


@dataclass
class _Captured:
    graph: object
    inputs: dict
    scalars: dict
    outputs: dict
    state_ptrs: list
    launches: dict = field(default_factory=dict)   # launch counts' moves per replay
    replays: int = 0


def _short_of_memory(failed: int, k: int) -> str:
    return (f"{failed} allocation(s) failed while warming up and capturing a group of {k} "
            "steps: a convolution may have taken another cuDNN algorithm than the eager "
            "steps; free the card's memory (other trainers' graphs) or run single steps")


def _first_unlike(got: Mapping, want: Mapping) -> str | None:
    """The first of ``got``'s tensors that is not bit-equal to ``want``'s
    (NaN equal to NaN), with its largest difference; None if all are."""
    for name, a in got.items():
        b = want[name]
        a = a.to(b.device)
        same = a == b
        if a.is_floating_point():
            same |= a.isnan() & b.isnan()
        if not bool(same.all()):
            diff = (a.double() - b.double()).abs()[~same].nan_to_num(nan=float("inf")).max()
            what = f"state tensor {name}" if isinstance(name, int) else name
            return f"{what}: largest difference {float(diff):.3e}"
    return None


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
                 device: torch.device, prepare: Callable[[], None] = lambda: None):
        self.body, self.state, self.prepare = (weak_callable(f) for f in (body, state, prepare))
        self.device = torch.device(device)
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
            self.graphs.pop(key, None)
            entry = self._capture(k, inputs, scalars)   # replayed once, and checked
            self.graphs[key] = entry
        else:
            self._fill(entry, inputs, scalars)
            entry.graph.replay()
        entry.replays += 1
        build.add_launches(entry.launches)
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

    def _capture(self, k: int, inputs, scalars) -> _Captured:
        """The group's graph, captured after its K eager steps and replayed
        once; refused (raises) as the module's docstring says."""
        static_in = {n: torch.empty_like(t, device=self.device) for n, t in inputs.items()}
        static_sc = {n: torch.empty_like(t, device=self.device) for n, t in scalars.items()}
        entry = _Captured(None, static_in, static_sc, {}, [])
        self._fill(entry, inputs, scalars)
        self.prepare()
        state = list(self.state())
        with torch.no_grad():
            saved = [t.detach().to("cpu", copy=True) for t in state]
        rng = torch.cuda.get_rng_state(self.device) if self.device.type == "cuda" else None
        ooms = self._ooms()
        try:
            want_metrics, want_state = self._warm_up(k, static_in, static_sc)
            self._put_back(state, saved, rng)
            before = launch_counts()
            graph, outputs = self._graph_capture(lambda: self._steps(k, static_in, static_sc))
            after = launch_counts()
            entry.launches = {key: after[key] - n for key, n in before.items() if after[key] != n}
            build.add_launches({key: -n for key, n in entry.launches.items()})
            failed = self._ooms() - ooms
            if failed:
                raise RuntimeError(_short_of_memory(failed, k))
            graph.replay()
            if self._deterministic():
                unlike = _first_unlike({**outputs, **dict(enumerate(state))},
                                       {**want_metrics, **dict(enumerate(want_state))})
                if unlike is not None:
                    raise RuntimeError(
                        f"the first replay of a group of {k} steps is not bit-equal to the same "
                        f"steps run eagerly from the same state ({unlike}): the graph computes "
                        "other numbers than the eager steps; free the card's memory (other "
                        "trainers' graphs) or run single steps")
        except torch.cuda.OutOfMemoryError as exc:
            self._put_back(state, saved, rng)
            raise RuntimeError(_short_of_memory(max(self._ooms() - ooms, 1), k)) from exc
        except BaseException:
            self._put_back(state, saved, rng)
            raise
        entry.graph, entry.outputs = graph, outputs
        entry.state_ptrs = self._state_ptrs()
        return entry

    def _ooms(self) -> int:
        """The caching allocator's count of failed allocations (0 off the
        card)."""
        if not (self.captures and torch.cuda.is_available()):
            return 0
        return torch.cuda.memory_stats(self.device).get("num_ooms", 0)

    @staticmethod
    def _deterministic() -> bool:
        """Whether the eager steps and a graph of the same kernels must be
        bit-equal: cuDNN (and every op) runs its deterministic algorithms."""
        return bool(torch.backends.cudnn.deterministic
                    or torch.are_deterministic_algorithms_enabled())

    def _put_back(self, state, saved, rng) -> None:
        """The state and the card's random-number state as they were saved."""
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        if rng is not None:
            torch.cuda.set_rng_state(rng, self.device)

    def _warm_up(self, k: int, inputs, scalars) -> tuple[dict, list]:
        """The K steps eagerly on a side stream: ``(metrics, state)``, the
        state after them copied to the host. The caller puts the state
        back."""
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            metrics = self._steps(k, inputs, scalars)
        if side is not None:
            torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            after = [t.detach().to("cpu", copy=True) for t in self.state()]
        self.warmup_steps += k
        if side is not None:
            # the memory the eager steps cached goes back to the card, so the
            # capture's pool can take it (a step's peak twice over does not
            # fit beside the f32 video step)
            torch.cuda.empty_cache()
        return metrics, after

    def _graph_capture(self, fn):
        """``(graph, outputs)``: ``fn`` captured into a CUDA graph on this
        runner's pool. A capture that fails raises, and leaves the card's
        random-number generator as it found it."""
        if self.captures and not self.graphs:
            # a pool whose graphs were all dropped takes no new capture (the
            # caching allocator asserts that it is still in use while its
            # blocks live on, e.g. as gradients): begin a fresh one
            self._pool = torch.cuda.graph_pool_handle()
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
