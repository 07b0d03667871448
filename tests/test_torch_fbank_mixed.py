"""The FFT route at an ``n_fft`` that is no power of two, on the CPU.

The kernel (``csrc/fbank_fft_kernel.cu``: ``fbank_mixed_fft_kernel``) runs
only on the card. Here: its plan (``fbank.fft_plan``: mixed radix 16, 8, 4,
2, 3, 5, 7, or Bluestein's chirp-z) returns at every size it takes and
raises outside them; the plain PyTorch version of the plan
(``fbank.rdft_by_plan``) against ``np.fft.rfft`` in float64; the twiddle,
chirp and chirp-filter tables against float64; the dispatch of such sizes
to the new wrapper; and the port's plain front-end against the JAX
package's Pallas kernels (interpret mode) at the sizes users run.
"""

import contextlib
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.ops import features as JF
from deeplip_tpu.ops.pallas.fbank_kernel import _v2_eligible, pallas_audio_features
from deeplip_tpu_torch.ops import features as TF
from deeplip_tpu_torch.ops import framing, spectral
from deeplip_tpu_torch.ops.cuda import fbank, launch_counts

torch.set_num_threads(1)

PLAN_SECONDS = 20   # the per-test time limit of the plan tests


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the test, rather than hang it, when the body outlasts
    ``seconds``."""
    def expired(signum, frame):
        raise TimeoutError(f"still running after {seconds} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("n_fft,n,m,radices", [
    (400, 200, 200, [8, 5, 5]),
    (441, 441, 441, [3, 3, 7, 7]),
    (480, 240, 240, [16, 3, 5]),
    (510, 255, 512, [16, 16, 2]),       # 255 = 3 * 5 * 17: Bluestein
    (768, 384, 384, [16, 8, 3]),
    (4095, 4095, 8192, [16, 16, 16, 2]),  # 13 divides 4095
])
def test_plan_and_flops_return(n_fft, n, m, radices):
    with time_limit(PLAN_SECONDS):
        plan = fbank.fft_plan(n_fft)
        flops = fbank.fft_flops(n_fft)
    assert (plan.n, plan.m, [r for r, _ in plan.passes]) == (n, m, radices)
    assert plan.packed is (n_fft % 2 == 0) and plan.bluestein is (m != n)
    ns = [s for _, s in plan.passes]
    assert ns == [int(np.prod(radices[:i])) for i in range(len(radices))]
    assert flops > 0


def test_plan_takes_every_size_of_the_route():
    """Every n_fft in [64, 4096] has a plan whose radices multiply to its
    transform's points, each transform at most 8192 points; sizes outside
    the route raise."""
    with time_limit(PLAN_SECONDS):
        for n_fft in range(fbank.FFT_SIZES[0], fbank.FFT_SIZES[1] + 1):
            plan = fbank.fft_plan(n_fft)
            assert np.prod([r for r, _ in plan.passes]) == plan.m <= 8192
            assert plan.n == (n_fft // 2 if n_fft % 2 == 0 else n_fft)
            if plan.bluestein:
                assert plan.m & (plan.m - 1) == 0 and plan.n * 2 - 1 <= plan.m < 4 * plan.n
            assert fbank.fft_flops(n_fft) > 0
        for n_fft in (32, 63, 4097, 8192):
            with pytest.raises(ValueError, match="FFT route"):
                fbank.fft_plan(n_fft)
            with pytest.raises(ValueError, match="FFT route"):
                fbank.fft_flops(n_fft)


def test_power_of_two_plan_is_the_fft_kernels():
    """At a power of two the plan is the FFT kernel's compile-time one
    (radix 16, then 2, 4 or 8), and its count is the kernel's."""
    for n_fft, radices in [(64, [16, 2]), (512, [16, 16]), (1024, [16, 16, 2]),
                           (4096, [16, 16, 8])]:
        plan = fbank.fft_plan(n_fft)
        assert [r for r, _ in plan.passes] == radices and not plan.bluestein
    assert fbank.fft_flops(512) == 7072


# ------------------------------------------------------ plain version of the plan
@pytest.mark.parametrize("dc_in_sample_order", [True, False])
@pytest.mark.parametrize("n_fft", [80, 96, 320, 400, 441, 480, 510, 768, 1000, 4000])
def test_plan_matches_numpy_rfft(n_fft, dc_in_sample_order):
    """Pre-emphasised f32 frames of n_fft samples and of fewer, through the
    plan in complex64, against float64 ``rfft``: each bin within rtol 1e-4,
    or, for a bin near zero, within 1e-6 of the frame's largest bin."""
    rng = np.random.default_rng(n_fft)
    for frame_len in (n_fft, (5 * n_fft) // 8 + 1):
        raw = torch.from_numpy((rng.standard_normal((24, frame_len + 1)) * 0.1)
                               .astype(np.float32))
        frames = framing.preemphasis(raw, 0.97)[:, 1:].contiguous()
        frames[7] = 0.0
        got = fbank.rdft_by_plan(frames, n_fft, dc_in_sample_order).numpy()
        assert got.dtype == np.complex64 and got.shape == (24, n_fft // 2 + 1)
        want = np.fft.rfft(frames.double().numpy(), n_fft)
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-6 * scale)
        assert not got[7].any()   # an all-zero frame stays exactly zero


def test_sample_order_dc_is_the_frames_sum():
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.standard_normal((5, 400)).astype(np.float32))
    dc = torch.zeros(5)
    for i in range(400):
        dc = dc + frames[:, i]
    for n_fft in (400, 510):
        got = fbank.rdft_by_plan(frames, n_fft)[:, 0]
        assert torch.equal(got.real, dc) and not got.imag.any()


# ------------------------------------------------------------------ tables
def _within_one_ulp(got: np.ndarray, want: np.ndarray, ref_err: float = 0.0) -> bool:
    """Each value within one f32 ulp of the float64 ``want``, give or take
    ``ref_err``, the float64 reference's own rounding (which decides only
    values that are 0 in exact arithmetic)."""
    ulp = np.spacing(np.abs(want).astype(np.float32))
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= ulp + ref_err))


@pytest.mark.parametrize("n_fft", [400, 441, 480, 768, 8192])
def test_twiddles_within_one_ulp_at_the_new_sizes(n_fft):
    tw = fbank.twiddles(n_fft)
    k = np.arange(n_fft)
    want = np.stack([np.cos(2 * np.pi * k / n_fft), -np.sin(2 * np.pi * k / n_fft)], -1)
    assert tw.dtype == np.float32 and _within_one_ulp(tw, want)


@pytest.mark.parametrize("n", [33, 255, 441, 2047, 4095])
def test_chirp_within_one_ulp(n):
    """The table reduces k^2 modulo 2n in integers; float64 holds k^2 < 2^53
    exactly, so the unreduced phase is a reference of its own, good to its
    phase's rounding: pi (n - 1)^2 / n * 2^-53 < 2e-12 at n = 4095."""
    k = np.arange(n, dtype=np.float64)
    want = np.exp(-1j * np.pi * k * k / n)
    got = fbank.chirp(n)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    assert _within_one_ulp(got, np.stack([want.real, want.imag], -1), 2e-12)


@pytest.mark.parametrize("n,m", [(255, 512), (509, 1024)])
def test_chirp_filter_within_one_ulp(n, m):
    """conj(B) / m against B summed directly in float64 (an m x m product,
    not an FFT)."""
    k = np.arange(m, dtype=np.float64)
    dist = np.minimum(k, m - k)                  # b[k] = conj(c[min(k, m - k)])
    b = np.where(dist < n, np.exp(1j * np.pi * dist * dist / n), 0.0)
    big = np.exp(-2j * np.pi * np.outer(k, k) / m) @ b
    want = np.conj(big) / m
    got = fbank.chirp_filter(n, m)
    assert got.dtype == np.float32 and got.shape == (m, 2)
    assert _within_one_ulp(got, np.stack([want.real, want.imag], -1),
                           1e-13 * float(np.abs(want).max()))


def test_logfbank_80_at_400_has_empty_filters():
    """Whisper's widths (80 filters, n_fft 400): the narrowest filters have
    no nonzero weight. Their CSR rows are empty, the CSR rebuilds the dense
    filterbank, and the plain front-end's guard gives log(eps) there."""
    dense = spectral.mel_filterbank(80, 400, 16000)
    idx, weights = fbank.mel_csr(80, 400, 16000)
    empty = np.flatnonzero(idx[1] == 0)
    assert empty.size > 0 and not dense[:, empty].any()
    rebuilt = np.zeros(dense.shape, np.float32)
    for m in range(80):
        rebuilt[idx[0, m]:idx[0, m] + idx[1, m], m] = weights[idx[2, m]:idx[2, m] + idx[1, m]]
    assert rebuilt.tobytes() == dense.astype(np.float32).tobytes()
    cfg = TF.FeatureConfig(feat_type="logfbank", n_fft=400, num_bin=80, normalize=False)
    rng = np.random.default_rng(4)
    got = fbank.audio_features(torch.from_numpy(
        (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)), cfg)
    log_eps = torch.log(torch.tensor(np.finfo(np.float64).eps, dtype=torch.float32))
    assert torch.all(got[..., torch.from_numpy(empty)] == log_eps)


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("n_fft", [65, 66, 400, 441, 480, 510, 768, 4000, 4095])
def test_other_sizes_take_the_mixed_kernel(n_fft):
    cfg = TF.FeatureConfig(n_fft=n_fft, win_len=min(0.025, n_fft / 16000))
    assert fbank.front_end_kernel(cfg) == "mixed"
    with pytest.raises(ValueError, match="power-of-two"):
        fbank.fft_audio_features(torch.zeros(1, 4000), cfg)
    with pytest.raises(ValueError, match="runs on cuda"):
        fbank.mixed_fft_audio_features(torch.zeros(1, 4000), cfg)
    for other in (512, 8192, 32):
        with pytest.raises(ValueError, match="no power of two"):
            fbank.mixed_fft_audio_features(
                torch.zeros(1, 4000), TF.FeatureConfig(n_fft=other, win_len=0.002))
    counts = launch_counts()
    fbank.audio_features(torch.zeros(2, 4000), cfg)
    assert counts == launch_counts()


# ------------------------------------------- the plain front-end vs Pallas
@pytest.mark.parametrize("feat_type,kw,seconds", [
    ("logfbank", {"n_fft": 400, "num_bin": 80}, 0.5),                # Whisper's widths
    ("mfcc", {"n_fft": 510}, 0.5),
    ("mfcc", {"rate": 44100, "n_fft": 441, "win_len": 0.01}, 0.25),
    ("logfbank", {"rate": 48000, "n_fft": 768, "win_len": 0.016, "num_bin": 40}, 0.25),
])
def test_plain_front_end_matches_pallas(feat_type, kw, seconds):
    """The port's plain front-end (what a CPU batch runs, and what the card
    holds the kernel to) against the JAX package's Pallas kernels in
    interpret mode, on the same f32 PCM, within the kernels' bar (atol
    2e-4, rtol 1e-3). 768 at 48 kHz takes the v2 kernel, the others v1."""
    jcfg = JF.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
    tcfg = TF.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
    assert _v2_eligible(jcfg) is (kw["n_fft"] == 768)
    rng = np.random.default_rng(kw["n_fft"])
    sig = (rng.standard_normal((2, int(seconds * tcfg.rate))) * 0.1).astype(np.float32)
    want = np.asarray(pallas_audio_features(jnp.asarray(sig), jcfg, interpret=True))
    got = fbank.audio_features(torch.from_numpy(sig), tcfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
