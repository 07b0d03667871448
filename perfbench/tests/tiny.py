"""Small cells for the CPU tests: the benchmark's configurations at narrow
widths and its traffic at a few rows, run through the harness on the CPU."""

from __future__ import annotations

import copy
import time

from perfbench import harness


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` of the benchmark, narrowed so a CPU runs it in
    seconds: the same files, read and then cut."""
    cell = harness.load_cell(name)
    config, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cell.spec["config"] == "etdnn-vox12":
        opts = config["model"]["etdnn"]
        opts["hidden_dim"] = [16] * 9 + [24]
        opts["embedding_dim"] = 12
        config["num_classes"] = 11
    else:
        config["num_classes"] = 5
        config["train"]["hidden_dim"] = 4
        config["train"]["crop"] = 24
        config["model"]["tcn_num_layers"] = 2
    if cell.spec["driver"] == "audio_score":
        t.update(utterances=20, seconds=0.5, batch=8, trials=50, pool=40, max_lists=8,
                 check_lists=2)
    elif cell.spec["driver"] == "audio_train":
        t.update(batch=6, pool=16, pool_seconds=4.5, max_steps=64)
    else:
        t.update(batch=3, frames=4, height=32, width=32, pool=8, max_steps=64)
    return harness.Cell(name, cell.spec, config, t)


def run_tiny(name: str, seed: int = 12345, seconds: float = 0.5, trace: bool = False,
             limits: dict | None = None, cell: harness.Cell | None = None) -> dict:
    import torch

    cell = cell or tiny_cell(name)
    if limits is not None:
        cell.spec = {**cell.spec, "limits": limits}
    bench = harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
    e2e, per_layer = harness.cell_metrics(bench, cell)
    return harness.execute(cell, e2e, per_layer, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter())
