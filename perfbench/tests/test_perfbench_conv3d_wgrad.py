"""``conv3d_wgrad_roofline`` reads the frontend weight gradient's least
time over both its passes' device time, and nothing where they are absent
or the step is bf16."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.metrics import _work

SHAPE = [128, 29, 44, 44, 64]


def _read(**window):
    base = dict(units=10, amount=1280.0, seconds=5.0, device_name="NVIDIA H100 80GB HBM3",
                work={"peak": "fp32", "flops": 1e13, "steps": 10, "itemsize": 4,
                      "pool_shape": SHAPE},
                step_ms=[500.0] * 10, busy_s=4.9, peak_bytes=0,
                kernels={"void (anonymous namespace)::conv3d_wgrad_kernel<64>(float const*)":
                         (10, 0.06),
                         "(anonymous namespace)::conv3d_wgrad_sum_kernel(float const*, int)":
                         (10, 0.0001),
                         "void cudnn::cnn::wgrad2d_grouped_direct_kernel<true>(x)": (1, 9.0)})
    base.update(window)
    reader = harness.load_module(harness.BENCH_DIR / "metrics" / "conv3d_wgrad_roofline.py", "m")
    return reader.read(harness.Window(**base))


def test_the_share_is_the_bound_over_both_passes():
    least = 2 * 64 * 245 * 128 * 29 * 44 * 44 / _work.H100_PEAKS["sxm"]["fp32"]
    assert round(least * 1e3, 2) == 3.36
    assert _read() == pytest.approx(100 * 10 * least / 0.0601)


def test_nothing_without_the_kernel_or_in_bf16():
    assert _read(kernels={"void cudnn::cnn::wgrad2d_grouped_direct_kernel<true>(x)": (1, 9.0)}) \
        is None
    bf16 = {"peak": "bf16", "flops": 1e13, "steps": 10, "itemsize": 2, "pool_shape": SHAPE}
    assert _read(work=bf16) is None
    assert _read(device_name="cpu") is None
