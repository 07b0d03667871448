"""What one run of a cell does, in order.

1. Find the cell's files by name (``workloads/``, ``configs/``,
   ``traffic/``, ``drivers/``) and the metrics ``BENCHMARK.json`` asks of it.
2. Refuse to run without as many CUDA cards as the cell asks for.
3. Set-up: the driver's ``PHASES`` in order. They build the program's
   object, make weights and data on the card from the seed, drive the
   object through the steps that its check reads and warm every shape the
   cell's traffic uses. ``setup_s`` runs from the process's start to the
   end of this.
4. The window: the driver's ``step`` back to back for ``--seconds`` of host
   clock, then one synchronise; the rate is all the work over all that
   time. With ``--trace 1`` the window runs under ``torch.profiler`` (events
   kept in memory) with a CUDA event pair around every unit.
5. The peak of device memory is read; then the program's state is freed and
   the driver's reference decides ``correct``.
6. A run whose process holds JAX, or the JAX package, prints no result.

The result is one JSON line on standard output; the compared numbers and
their limits are the last lines of standard error and the last key
(``checks``) of the line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deeplip_tpu")
TOP_OPS = 10   # entries of each list in ``breakdown``


class CellError(RuntimeError):
    """The cell's files or the machine do not allow the run."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a benchmark file by its path (cell, metric and reference files
    are named after cells and metrics, which may hold dots and dashes)."""
    if not path.is_file():
        raise CellError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that are JAX
    or the JAX package, compared whole (``deeplip_tpu_torch`` is not
    ``deeplip_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def sub_seed(seed: int, k: int) -> int:
    """An independent seed for the ``k``-th stream of a run's ``--seed``."""
    return (int(seed) * 1_000_003 + 7919 * k) % (2 ** 62)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict        # workloads/<cell>.json
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    spec = load_json(_need(bench_dir / "workloads" / f"{name}.json"))
    config = load_json(_need(bench_dir / "configs" / f"{spec['config']}.json"))
    traffic = load_json(_need(bench_dir / "traffic" / f"{spec['traffic']}.json"))
    return Cell(name, spec, config, traffic)


def _need(path: Path) -> Path:
    if not path.is_file():
        raise CellError(f"missing {path}")
    return path


def reference_module(config_name: str, bench_dir: Path = BENCH_DIR):
    """``reference/<config, '-' and '.' as '_'>.py``."""
    stem = config_name.replace("-", "_").replace(".", "_")
    return load_module(bench_dir / "reference" / f"{stem}.py", f"perfbench_reference_{stem}")


def cell_metrics(bench: dict, cell: Cell) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` asks of the
    cell: those that list it, or list no cells (a per-layer metric then
    goes with every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell.name in m.get("workloads", [cell.name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's seed and the device."""

    cell: Cell
    seed: int
    device: object          # torch.device
    bench_dir: Path = BENCH_DIR

    def seed_for(self, k: int) -> int:
        return sub_seed(self.seed, k)

    def reference(self):
        return reference_module(self.cell.spec["config"], self.bench_dir)


@dataclasses.dataclass
class Window:
    """One measured window, as the metric readers see it."""

    units: int                  # driver steps (lists, train steps) in the window
    amount: float               # what the rate counts (trials, samples)
    seconds: float              # host clock over the window, the final synchronise included
    work: dict                  # the driver's per-step work (metrics/_work.py terms)
    device_name: str
    step_ms: list = dataclasses.field(default_factory=list)
    busy_s: float | None = None
    kernels: dict = dataclasses.field(default_factory=dict)   # name -> (launches, seconds)
    peak_bytes: int | None = None


# ------------------------------------------------------------------ trace
def _device_intervals(events, cuda_type) -> tuple[list, dict]:
    spans, by_name = [], {}
    for e in events:
        # user annotations (the benchmark's ``perfbench.`` ranges mirrored
        # on the device's timeline) are no device operations
        if e.device_type() != cuda_type or e.is_user_annotation() or e.name().startswith(
                "perfbench."):
            continue
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        spans.append((start, start + dur))
        name = e.name()
        n, t = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, t + dur)
    spans.sort()
    return spans, by_name


def _merged(spans: list) -> list:
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_ops(events, cpu_type) -> dict:
    """Host events by thread, each ``(start, end, name)`` sorted by start;
    the benchmark's own ``perfbench.`` ranges are left out."""
    threads: dict = {}
    for e in events:
        if e.device_type() != cpu_type:
            continue
        name = e.name()
        if name.startswith("perfbench."):
            continue
        s = e.start_ns()
        threads.setdefault(e.start_thread_id(), []).append((s, s + e.duration_ns(), name))
    for evs in threads.values():
        evs.sort()
    return threads


def _innermost(threads: dict, points: list) -> list:
    """For each sorted time in ``points``, the name of the innermost host
    event running then (of all threads, the one that began last), or
    ``"(no host op)"``."""
    best = [(-1, "(no host op)")] * len(points)
    for evs in threads.values():
        stack, j = [], 0
        for i, p in enumerate(points):
            while j < len(evs) and evs[j][0] <= p:
                s, e, name = evs[j]
                while stack and stack[-1][1] <= s:
                    stack.pop()
                stack.append(evs[j])
                j += 1
            while stack and stack[-1][1] <= p:
                stack.pop()
            if stack and stack[-1][0] > best[i][0]:
                best[i] = (stack[-1][0], stack[-1][2])
    return [name for _, name in best]


def _top(totals: dict) -> list:
    return [[name[:200], seconds] for name, seconds in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP_OPS]]


def reduce_trace(prof) -> dict:
    """``busy_s`` (the union of device operations), kernel time by name, and
    ``breakdown``: the device operations that took most time, and the idle
    gaps (from the window's first unit on) summed by the innermost host
    event running in their middle."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, by_name = _device_intervals(events, DeviceType.CUDA)
    merged = _merged(spans)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    starts = [e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU and e.name() == "perfbench.unit"]
    if merged and starts and merged[0][0] > min(starts):
        gaps.append((min(starts), merged[0][0]))
    gaps.sort(key=lambda g: g[0] + g[1])
    names = _innermost(_host_ops(events, DeviceType.CPU), [(s + e) // 2 for s, e in gaps])
    idle: dict = {}
    for (s, e), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    kernels = {n: (c, t / 1e9) for n, (c, t) in by_name.items()}
    return {"busy_s": sum(e - s for s, e in merged) / 1e9, "kernels": kernels,
            "breakdown": {"device_ops": _top({n: t for n, (_, t) in kernels.items()}),
                          "idle_gaps": _top(idle)}}


# ------------------------------------------------------------------ window
def measure(driver, seconds: float, trace: bool, device) -> tuple[Window, dict]:
    """Run ``driver.step`` back to back for ``seconds`` of host clock and
    synchronise. Returns the window and, with ``trace``, the reduced trace."""
    import torch

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pairs, units, amount = [], 0, 0.0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
    sync()
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            if trace and cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            with record_function("perfbench.unit") if trace else contextlib.nullcontext():
                amount += driver.step(units)
            if trace and cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                pairs.append((start, end))
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        t1 = time.perf_counter()
    window = Window(units, amount, t1 - t0, driver.work(), device_name(device),
                    step_ms=[s.elapsed_time(e) for s, e in pairs])
    reduced = {}
    if prof is not None:
        reduced = reduce_trace(prof)
        window.busy_s, window.kernels = reduced["busy_s"], reduced["kernels"]
    return window, reduced


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def read_metrics(metrics: list[dict], window: Window, bench_dir: Path = BENCH_DIR) -> dict:
    """Each per-layer metric from its reader, ``metrics/<name>.py: read``;
    a reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(window)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ------------------------------------------------------------------ a run
def execute(cell: Cell, e2e: list, per_layer: list, seed: int, seconds: float, trace: bool,
            device, start: float, bench_dir: Path = BENCH_DIR) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    line's object."""
    import torch

    ctx = Context(cell, seed, device, bench_dir)
    module = load_module(bench_dir / "drivers" / f"{cell.spec['driver']}.py",
                         "perfbench_driver_" + cell.spec["driver"])
    driver = module.Driver(ctx)
    cuda = device.type == "cuda"
    phases = {"before": time.perf_counter() - start}
    for phase in driver.PHASES:
        begun = time.perf_counter()
        getattr(driver, phase)()
        phases[phase] = time.perf_counter() - begun
    print(f"perfbench: {cell.name} set-up by phase (s): "
          + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()), file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - start

    window, reduced = measure(driver, seconds, trace, device)
    if cuda:
        window.peak_bytes = torch.cuda.max_memory_allocated(device)
    outcome = driver.finish()
    memory_peak = max(setup_peak, window.peak_bytes) if cuda else 0

    metrics = {}
    if trace:
        metrics = read_metrics(per_layer, window, bench_dir)
    else:
        rate = cell.spec["rate_metric"]
        units = {m["name"]: m["unit"] for m in e2e}
        if rate in units:
            metrics[rate] = {"value": window.amount / window.seconds, "unit": units[rate]}
        if "setup_s" in units:
            metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}

    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.spec.get("limits", {})
    numbers = dict(driver.check())
    # the numbers the cell's limits name are compared; without limits (a
    # cell being calibrated) every number is shown and none passes
    checks = {name: {"value": float(numbers[name]) if name in numbers else math.nan,
                     "limit": limit} for name, limit in limits.items()} or {
        name: {"value": float(value), "limit": None} for name, value in numbers.items()}
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    correct = correct and outcome["failed"] == 0

    device_info = {"platform": "gpu" if cuda else device.type, "kind": window.device_name,
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]), "metrics": metrics, "device": device_info}
    if trace and window.busy_s is not None:
        device_info["busy_s"] = window.busy_s
        device_info["window_s"] = window.seconds
        result["breakdown"] = reduced["breakdown"]
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run in it builds. The program's own kernels build
    under ``deeplip_tpu_torch/_build/``."""
    cache = os.path.join(root, ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             start: float) -> int:
    """The command's body: prints the result line and returns the exit
    code (2: the cell's files, 3: no card, 4: JAX in the process)."""
    cache_dirs(root)
    try:
        bench = load_json(_need(Path(root) / "BENCHMARK.json"))
        cell = load_cell(workload)
        e2e, per_layer = cell_metrics(bench, cell)
    except (CellError, KeyError, json.JSONDecodeError) as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(cell, e2e, per_layer, seed, seconds, trace, torch.device("cuda", 0), start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print("\n".join(check_lines(result["checks"])), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
