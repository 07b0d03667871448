#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--controls 3] [--out readings.json]

For each seed, the program's numbers against the reference (the lower
reading, from sound runs); for the first ``--controls`` seeds also the
control (the reference in the program's place, in the precision below the
configuration's: TF32 for f32 paths, float8 operands for bf16 ones) and the
half-batch fault (the reference in the program's place on half of each
batch), each against the reference. A scoring cell runs a short window so
that the lists it checks come from a window as in a run; a training cell
reads its set-up steps, as a run does. Prints one JSON line per seed and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOWER = {"f32": "tf32", "bf16": "fp8"}
SCORE_WINDOW_S = 2.0


def readings(cell, seed: int, with_controls: bool, device) -> dict:
    import torch

    from perfbench import compare, harness

    ctx = harness.Context(cell, seed, device)
    module = harness.load_module(harness.BENCH_DIR / "drivers" / f"{cell.spec['driver']}.py",
                                 "perfbench_driver_" + cell.spec["driver"])
    driver = module.Driver(ctx)
    precision = cell.traffic["precision"]
    out = {"cell": cell.name, "seed": seed}
    t0 = time.perf_counter()
    driver.prepare()
    if cell.spec["driver"] == "audio_score":
        driver.warm()
        harness.measure(driver, SCORE_WINDOW_S, False, device)
        driver.finish()
    else:
        driver.checked()
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["program_s"] = time.perf_counter() - t0
    if cell.spec["driver"] == "audio_score":
        ref = driver.reference_outputs(precision)
        out["program"] = dict(driver.numbers(driver.kept, ref))
        if with_controls:
            out["control"] = dict(driver.numbers(driver.reference_outputs(LOWER[precision]), ref))
            out["half_batch"] = dict(driver.numbers(driver.reference_outputs(precision, half=True),
                                                    ref))
    else:
        ref = driver.reference_readings(precision)
        out["program"] = dict(compare.train_numbers(driver.program, ref))
        out["worst_grad"] = compare.worst_leaves(driver.program["first_grad"], ref["first_grad"])
        out["worst_change"] = compare.worst_leaves(driver.program["change"], ref["change"],
                                                   compare.moving_leaves(ref["first_grad"]))
        out["losses"] = [driver.program["losses"], ref["losses"]]
        if precision == "bf16":   # the recipe's own rounding: bf16 against f32
            out["f32_vs_recipe"] = dict(compare.train_numbers(driver.reference_readings("f32"),
                                                              ref))
        if with_controls:
            out["control"] = dict(compare.train_numbers(
                driver.reference_readings(LOWER[precision]), ref))
            half = int(cell.traffic["batch"]) // 2
            out["half_batch"] = dict(compare.train_numbers(
                driver.reference_readings(precision, keep=half), ref))
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3, help="seeds that also read the controls")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    harness.cache_dirs(ROOT)
    cell = harness.load_cell(args.workload)
    rows = []
    for k, seed in enumerate(args.seeds):
        rows.append(readings(cell, seed, k < args.controls, torch.device("cuda", 0)))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
