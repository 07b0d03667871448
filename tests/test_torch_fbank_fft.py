"""What Python computes around the FFT front-end kernel, on the CPU.

The kernel (``csrc/fbank_fft_kernel.cu``) runs only on the card. Here: its
constants (the mel filterbank by filter, the twiddle table), its radix plan
and untangle in torch (``fbank.rdft_by_plan``) against ``np.fft.rfft`` and
the JAX package's ``dft='fft'`` power spectrum, the rule that picks between
the FFT and the DFT kernel, and the wrapper's plain path with pre-emphasis
and ``sample_lengths`` against the sequence it replaced.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.ops import features as JF
from deeplip_tpu_torch.ops import features as TF
from deeplip_tpu_torch.ops import framing, spectral
from deeplip_tpu_torch.ops.cuda import fbank, launch_counts

torch.set_num_threads(1)


# ------------------------------------------------ the kernel's plan, emulated
def sample_order_sum(frames: torch.Tensor) -> torch.Tensor:
    """Each frame's sum in sample order, one f32 addition at a time: the
    kernel's DC bin."""
    dc = torch.zeros_like(frames[..., 0])
    for i in range(frames.shape[-1]):
        dc = dc + frames[..., i]
    return dc


def rfft_emulation(frames: torch.Tensor, n_fft: int,
                   dc_in_sample_order: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``(re, im)`` of the FFT route's transform by its plan's plain version
    (``fbank.rdft_by_plan``: the packing, the kernel's radix plan and f32
    twiddles, the untangle), ``(..., n_fft//2+1)`` each, for ``(..., L)``
    f32 frames (``L <= n_fft``). The DC bin is the frame's sum in sample
    order, as the kernel takes it, unless ``dc_in_sample_order`` is false:
    then it is the packed FFT's ``Z[0].re + Z[0].im``."""
    x = fbank.rdft_by_plan(frames, n_fft, dc_in_sample_order)
    return x.real, x.imag


FILTERBANKS = [
    (26, 512, 16000),
    (60, 512, 16000),
    (24, 512, 16000),
    (40, 1024, 22050),
    (23, 256, 8000),
    (40, 2048, 16000),
    (40, 1024, 44100, 20.0, 8000.0),
]


@pytest.mark.parametrize("args", FILTERBANKS)
def test_mel_csr_rebuilds_the_dense_filterbank(args):
    dense = spectral.mel_filterbank(*args)
    idx, weights = fbank.mel_csr(*args)
    first, count, offset = idx
    rebuilt = np.zeros(dense.shape, np.float32)
    for m in range(dense.shape[1]):
        rebuilt[first[m]:first[m] + count[m], m] = weights[offset[m]:offset[m] + count[m]]
    assert rebuilt.tobytes() == dense.astype(np.float32).tobytes()
    assert weights.size == np.count_nonzero(dense)      # no zero inside a filter


def test_mel_csr_default_keeps_the_nonzero_weights_only():
    idx, weights = fbank.mel_csr(26, 512, 16000)
    assert weights.size == 459 and idx[1].sum() == 459   # of 257 x 26 = 6,682


@pytest.mark.parametrize("n_fft", [64, 510, 512, 4096])
def test_twiddles_within_one_f32_ulp(n_fft):
    tw = fbank.twiddles(n_fft)
    k = np.arange(n_fft)
    want = np.stack([np.cos(2 * np.pi * k / n_fft), -np.sin(2 * np.pi * k / n_fft)], -1)
    assert tw.dtype == np.float32 and tw.shape == (n_fft, 2)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(tw.astype(np.float64) - want) <= ulp)


@pytest.mark.parametrize("dc_in_sample_order", [True, False])
@pytest.mark.parametrize("n_fft,frame_len", [(64, 64), (256, 200), (512, 400),
                                             (1024, 551), (2048, 2048)])
def test_emulated_radix_plan_matches_numpy_rfft(n_fft, frame_len, dc_in_sample_order):
    # pre-emphasised frames, as the kernel sees them
    rng = np.random.default_rng(n_fft)
    raw = torch.from_numpy((rng.standard_normal((40, frame_len + 1)) * 0.1).astype(np.float32))
    frames = framing.preemphasis(raw, 0.97)[:, 1:].contiguous().numpy()
    frames[7] = 0.0
    frames[11, 3:] = 0.0
    re, im = rfft_emulation(torch.from_numpy(frames), n_fft, dc_in_sample_order)
    assert re.dtype == torch.float32 and re.shape == (40, n_fft // 2 + 1)
    want = np.fft.rfft(frames.astype(np.float64), n_fft)
    err = np.abs(re.numpy() + 1j * im.numpy() - want).max(axis=1)
    norm = np.linalg.norm(frames.astype(np.float64), axis=1)
    assert np.all(err <= 1e-6 * norm)
    # an all-zero frame stays exactly zero through every pass
    assert not re[7].any() and not im[7].any()


def test_sample_order_dc_is_closer_to_float64_than_the_packed_fft():
    """Why the kernel sums the DC bin apart. After pre-emphasis the running
    sum of a frame telescopes (sum e[n] = x[last] + (1 - a) sum x[n] + ...),
    so its partial sums stay a sample's size; the packed FFT's Z[0].re +
    Z[0].im adds two half-frame sums of the frame's own size that cancel.
    Frames as the lomgrid batch has them (int16 noise / 32768, 400 samples,
    pre-emphasised in f32), each sum against the float64 sum of the same
    f32 samples."""
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.integers(-8000, 8000, (20000, 401)).astype(np.float32) / 32768)
    frames = framing.preemphasis(raw, 0.97)[:, 1:].contiguous()
    exact = frames.double().sum(-1)
    packed = rfft_emulation(frames, 512, dc_in_sample_order=False)[0][:, 0]
    in_order = rfft_emulation(frames, 512)[0][:, 0]
    assert torch.equal(in_order, sample_order_sum(frames))
    err_packed = (packed.double() - exact).abs()
    err_order = (in_order.double() - exact).abs()
    rms = lambda e: float(e.square().mean().sqrt())
    assert rms(err_packed) > 2 * rms(err_order)
    assert float(err_packed.max()) > 2 * float(err_order.max())


def test_emulated_power_matches_jax_fft_power_spectrum():
    """The emulation's ``|X|^2 / n_fft`` of pre-emphasised frames against
    the JAX package's ``dft='fft'`` power spectrum."""
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    cfg = TF.FeatureConfig(normalize=False)
    want = np.asarray(JF._power_spectrum(jnp.asarray(sig),
                                         JF.FeatureConfig(normalize=False, dft="fft")))
    frames = framing.frame_signal(framing.preemphasis(torch.from_numpy(sig), cfg.preemph),
                                  cfg.frame_len, cfg.frame_step)
    re, im = rfft_emulation(frames, cfg.n_fft)
    got = ((re * re + im * im) / cfg.n_fft).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9 * float(want.max()))


@pytest.mark.parametrize("n_fft,fft", [(64, True), (256, True), (512, True), (1024, True),
                                       (2048, True), (4096, True), (510, True),
                                       (32, False), (8192, False), (400, True)])
def test_dispatch_rule(n_fft, fft):
    """Every n_fft in [64, 4096] takes the FFT route: a power of two its
    compile-time plan, any other size its mixed-radix plan; the rest only
    the plain version on a CPU batch, and a CUDA batch at one is refused."""
    cfg = TF.FeatureConfig(n_fft=n_fft, win_len=min(0.025, n_fft / 16000))
    power_of_two = n_fft & (n_fft - 1) == 0
    assert fbank.front_end_kernel(cfg) == (
        "plain" if not fft else "fft" if power_of_two else "mixed")
    if not (fft and power_of_two):
        with pytest.raises(ValueError, match="power-of-two"):
            fbank.fft_audio_features(torch.zeros(1, 4000), cfg)
    if not fft:
        # The refusal comes before any read of the batch, so a stand-in
        # that only names a CUDA device reaches it on the CPU.
        on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
        launches = launch_counts()
        with pytest.raises(ValueError, match=f"no front-end kernel takes n_fft {n_fft}"):
            fbank.audio_features(on_card, cfg)
        assert launches == launch_counts()


def _three_passes(sig: torch.Tensor, cfg, lengths: torch.Tensor) -> torch.Tensor:
    """What ``extract_features`` did before the kernels took pre-emphasis
    and the mask: three elementwise passes, then the plain front-end."""
    emph = framing.preemphasis(sig, cfg.preemph)
    idx = torch.arange(sig.shape[-1])
    emph = emph * (idx < lengths[..., None]).to(sig.dtype)
    fn = {"mfcc": TF.mfcc, "fbank": TF.fbank, "logfbank": TF.logfbank}[cfg.feat_type]
    return fn(emph, dataclasses.replace(cfg, preemph=0.0))


@pytest.mark.parametrize("feat_type,kw", [
    ("mfcc", {"energy": True}),
    ("mfcc", {"energy": False}),
    ("fbank", {"num_bin": 24}),
    ("logfbank", {"num_bin": 60}),
    ("mfcc", {"rate": 22050, "n_fft": 1024, "num_bin": 40, "num_cep": 13}),
])
def test_plain_path_bit_equal_to_the_three_passes(feat_type, kw):
    rng = np.random.default_rng(11)
    cfg = TF.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
    sig = torch.from_numpy((rng.standard_normal((3, 9000)) * 0.1).astype(np.float32))
    lengths = torch.tensor([9000, 5123, 0], dtype=torch.int32)
    want = _three_passes(sig, cfg, lengths)
    got = fbank.audio_features(sig, cfg, lengths)
    assert torch.equal(got, want)
    assert torch.equal(TF.extract_features(sig, cfg, sample_lengths=lengths), want)
    # rows past their length are exact zeros: log-mel there is log(eps)
    if feat_type == "logfbank":
        assert torch.all(got[2] == torch.log(torch.tensor(np.finfo(np.float64).eps,
                                                          dtype=torch.float32)))


def test_only_a_cpu_tensor_reaches_the_plain_version():
    cfg = TF.FeatureConfig(normalize=False)
    meta = torch.empty((2, 4000), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fbank.audio_features(meta, cfg)
    with pytest.raises(ValueError, match="runs on cuda"):
        fbank.fft_audio_features(torch.zeros(2, 4000), cfg)
    launches = launch_counts()
    fbank.audio_features(torch.zeros(2, 4000), cfg)
    assert launches == launch_counts()
