"""The frozen work arithmetic reproduces the bounds of ``PERF.md``'s kernel
table, and the per-layer readers compute from it."""

from __future__ import annotations

import math

import pytest

from perfbench import harness
from perfbench.metrics import _work

SXM = _work.H100_PEAKS["sxm"]
MFCC = {"feat_type": "mfcc", "rate": 16000, "n_fft": 512, "num_bin": 26, "num_cep": 24,
        "energy": True, "win_len": 0.025, "win_shift": 0.01}


def test_k1_bound_at_the_sweep_batch():
    ms = _work.bound_s(_work.front_end_work(256, 48000, MFCC), SXM) * 1e3
    assert round(ms, 4) == 0.0169


@pytest.mark.parametrize("itemsize,fwd,bwd", [(4, 3.251, 5.418), (2, 1.625, 2.709)])
def test_bn_prelu_bounds_per_lipreading_step(itemsize, fwd, bwd):
    sites = _work.lipreading_bn_sites(128, 29)
    got = {k: 1e3 * sum(c * _work.bn_bound_s(math.prod(s), itemsize, SXM, k) for s, c in sites)
           for k in ("fwd", "bwd")}
    assert (round(got["fwd"], 3), round(got["bwd"], 3)) == (fwd, bwd)


def test_bn_sites_are_the_nine_of_the_training_shape():
    sites = _work.lipreading_bn_sites(128, 29)
    assert sum(c for _, c in sites) == 9
    assert [s for s, _ in sites] == [(128, 29, 44, 44, 64), (3712, 22, 22, 64),
                                     (3712, 11, 11, 128), (3712, 6, 6, 256), (3712, 3, 3, 512)]


def test_maxpool_bounds_at_the_training_shape():
    b = _work.pool_bounds_s((128, 29, 44, 44, 64), 4, SXM)
    assert (round(b["fwd"] * 1e3, 4), round(b["bwd"] * 1e3, 4)) == (0.6865, 0.7208)


def test_fft_count_and_mel_weights_match_the_program():
    from deeplip_tpu_torch.ops.cuda import fbank

    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        m = n_fft // 2
        assert _work.fft_flops(n_fft) == min(float(fbank.fft_flops(n_fft)), 5 * m * math.log2(m))
    _, weights = fbank.mel_csr(26, 512, 16000)
    assert _work.mel_nonzeros(26, 512, 16000) == weights.size


def test_kernel_names_match_at_word_boundaries():
    kernels = {"void apply_kernel<float>(float const*)": (2, 1.0),
               "void bwd_apply_kernel<float>(float const*)": (3, 2.0),
               "(anonymous namespace)::fbank_fft_kernel(float const*, int)": (1, 4.0),
               "void at::native::vectorized_elementwise_kernel<4>(int)": (5, 8.0)}
    assert _work.kernel_seconds(kernels, ("apply_kernel",)) == (2, 1.0)
    assert _work.kernel_seconds(kernels, ("bwd_apply_kernel", "fbank_fft_kernel")) == (4, 6.0)


def test_readers_compute_from_the_window():
    window = harness.Window(
        units=10, amount=2560.0, seconds=2.0, device_name="NVIDIA H100 80GB HBM3",
        work={"peak": "bf16", "flops": 1.978e13, "steps": 10, "itemsize": 2,
              "bn_sites": _work.lipreading_bn_sites(128, 29),
              "pool_shape": [128, 29, 44, 44, 64]},
        step_ms=[float(i) for i in range(1, 101)], busy_s=1.5,
        kernels={"void apply_kernel<c10::BFloat16>(x)": (90, 0.05),
                 "maxpool_fwd_kernel<c10::BFloat16>(x)": (10, 0.01)},
        peak_bytes=3 * 2 ** 30)

    def read(name):
        return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", "m").read(window)

    assert read("mfu.train") == pytest.approx(1.0)
    assert read("idle_pct.train") == pytest.approx(25.0)
    assert read("peak_mem_gib.train") == pytest.approx(3.0)
    assert read("step_ms_p95.train") == pytest.approx(95.95)
    sites_bound = 10 * _work.bn_step_bound_s(window.work["bn_sites"], 2, _work.H100_PEAKS["sxm"])
    assert read("bn_prelu_roofline") == pytest.approx(100 * sites_bound / 0.05)
    assert read("k1_roofline") is None            # no front-end kernel in the trace
    window.device_name = "cpu"
    assert read("mfu.train") is None and read("maxpool_roofline") is None


def test_busy_time_is_the_union_and_gaps_take_the_innermost_host_event():
    assert harness._merged([(0, 10), (5, 20), (30, 40)]) == [[0, 20], [30, 40]]
    threads = {1: [(0, 100, "step"), (20, 35, "aten::mul"), (50, 60, "cudaLaunchKernel")],
               2: [(0, 100, "backward"), (22, 30, "aten::sum")]}
    assert harness._innermost(threads, [25, 40, 55, 200]) == [
        "aten::sum", "step", "cudaLaunchKernel", "(no host op)"]
