#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``perfbench/__init__.py`` for the layout
and ``harness.py`` for what a run does.
"""

import time

START = time.perf_counter()   # set-up counts from here, before torch is imported

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: profile the window and report the per-layer metrics")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import harness

    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            start=START)


if __name__ == "__main__":
    sys.exit(main())
