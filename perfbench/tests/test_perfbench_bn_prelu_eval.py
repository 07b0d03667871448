"""``bn_prelu_eval_ms.train`` reads the eval kernel's device time a unit, by
its name alone, and nothing where the trace holds none of it."""

from __future__ import annotations

import pytest

from perfbench import harness

EVAL = "void (anonymous namespace)::bn_prelu_eval_kernel<float, 4, 0>(float const*, int)"
TRAIN = "void (anonymous namespace)::apply_kernel<float>(float const*, float*, long long, int)"


def _read(kernels, units=10):
    window = harness.Window(units=units, amount=600.0, seconds=1.2,
                            work={"peak": "fp32", "steps": units},
                            device_name="NVIDIA H100 80GB HBM3", kernels=kernels)
    reader = harness.load_module(harness.BENCH_DIR / "metrics" / "bn_prelu_eval_ms.train.py",
                                 "m")
    return reader.read(window)


def test_the_kernel_time_a_unit():
    both = EVAL.replace("<float, 4, 0>", "<float, 4, 2>")
    assert _read({EVAL: (170, 0.04), both: (30, 0.01), TRAIN: (9, 5.0)}) == pytest.approx(5.0)


def test_nothing_without_the_kernel():
    assert _read({TRAIN: (9, 5.0)}) is None
    assert _read({}) is None
