"""What Python computes around the FFT front-end kernel, on the CPU.

The kernel (``csrc/fbank_fft_kernel.cu``) runs only on the card. Here: its
constants (the mel filterbank by filter, the twiddle table), a torch
emulation of its radix plan and untangle against ``np.fft.rfft`` and the
JAX package's ``dft='fft'`` power spectrum, the rule that picks between the
FFT and the DFT kernel, and the wrapper's plain path with pre-emphasis and
``sample_lengths`` against the sequence it replaced.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.ops import features as JF
from deeplip_tpu_torch.ops import features as TF
from deeplip_tpu_torch.ops import framing, spectral
from deeplip_tpu_torch.ops.cuda import fbank

torch.set_num_threads(1)


# --------------------------------------- the kernel's arithmetic, emulated
def _cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def _small_dft(vr: list, vi: list) -> tuple[list, list]:
    """The kernel's in-register DFT of ``len(vr)`` points (``SmallDft`` in
    the ``.cu``), with the 16th roots rounded once to f32."""
    w16 = fbank.twiddles(16)
    radix = len(vr)
    for p, ns in fbank._small_plan(radix):
        q = radix // p
        outr, outi = [None] * radix, [None] * radix
        for j in range(q):
            ur, ui = [], []
            for r in range(p):
                k, a, b = fbank._w16_index(j, r, p, ns), vr[j + r * q], vi[j + r * q]
                if k % 4:
                    a, b = _cmul(a, b, float(w16[k, 0]), float(w16[k, 1]))
                else:   # 1, -i, -1, i: exact
                    a, b = [(a, b), (b, -a), (-a, -b), (-b, a)][k // 4]
                ur.append(a)
                ui.append(b)
            if p == 4:
                a0r, a0i = ur[0] + ur[2], ui[0] + ui[2]
                a1r, a1i = ur[0] - ur[2], ui[0] - ui[2]
                a2r, a2i = ur[1] + ur[3], ui[1] + ui[3]
                a3r, a3i = ui[1] - ui[3], ur[3] - ur[1]          # -i (u1 - u3)
                ur = [a0r + a2r, a1r + a3r, a0r - a2r, a1r - a3r]
                ui = [a0i + a2i, a1i + a3i, a0i - a2i, a1i - a3i]
            else:
                ur = [ur[0] + ur[1], ur[0] - ur[1]]
                ui = [ui[0] + ui[1], ui[0] - ui[1]]
            d = (j // ns) * ns * p + j % ns
            for r in range(p):
                outr[d + r * ns], outi[d + r * ns] = ur[r], ui[r]
        vr, vi = outr, outi
    return vr, vi


def sample_order_sum(frames: torch.Tensor) -> torch.Tensor:
    """Each frame's sum in sample order, one f32 addition at a time: the
    kernel's DC bin."""
    dc = torch.zeros_like(frames[..., 0])
    for i in range(frames.shape[-1]):
        dc = dc + frames[..., i]
    return dc


def rfft_emulation(frames: torch.Tensor, n_fft: int,
                   dc_in_sample_order: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFT kernel's arithmetic in torch: ``(..., L)`` frames (``L <=
    n_fft``) -> ``(re, im)`` of their ``n_fft``-point real DFT, ``(...,
    n_fft//2+1)`` each, by the kernel's radix plan (``fbank.fft_plan``),
    packing ``z[n] = e[2n] + i e[2n+1]`` and untangling bins ``k`` and
    ``N-k`` as the kernel does, in the frames' dtype. The DC bin is the
    frame's sum in sample order, as the kernel takes it, unless
    ``dc_in_sample_order`` is false: then it is the packed FFT's
    ``Z[0].re + Z[0].im``."""
    n = n_fft // 2
    e = torch.nn.functional.pad(frames, (0, n_fft - frames.shape[-1]))
    zr, zi = e[..., 0::2], e[..., 1::2]
    tw = torch.from_numpy(fbank.twiddles(n_fft)).to(frames.device, frames.dtype)
    wr, wi = tw[:, 0], tw[:, 1]
    for i, (radix, ns) in enumerate(fbank.fft_plan(n_fft)):
        q = n // radix
        j = torch.arange(q, device=frames.device)
        m = (j % ns) * (n_fft // (ns * radix))
        vr = [zr[..., j + r * q] for r in range(radix)]
        vi = [zi[..., j + r * q] for r in range(radix)]
        for r in range(1, radix if i else 1):
            vr[r], vi[r] = _cmul(vr[r], vi[r], wr[r * m], wi[r * m])
        yr, yi = _small_dft(vr, vi)
        d = (j // ns) * ns * radix + j % ns
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        for r in range(radix):
            zr[..., d + r * ns] = yr[r]
            zi[..., d + r * ns] = yi[r]
    k = torch.arange(n + 1, device=frames.device)
    ar, ai = zr[..., k % n], zi[..., k % n]
    br, bi = zr[..., (n - k) % n], zi[..., (n - k) % n]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, o_i = 0.5 * (ai + bi), -0.5 * (ar - br)
    xr, xi = _cmul(o_r, o_i, wr[k], wi[k])
    xr, xi = er + xr, ei + xi
    if dc_in_sample_order:
        xr[..., 0], xi[..., 0] = sample_order_sum(frames), 0.0
    return xr, xi

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
                                       (2048, True), (4096, True), (510, False),
                                       (32, False), (8192, False), (400, False)])
def test_dispatch_rule(n_fft, fft):
    cfg = TF.FeatureConfig(n_fft=n_fft, win_len=min(0.025, n_fft / 16000))
    assert fbank.uses_fft_kernel(cfg) is fft
    if not fft:
        with pytest.raises(ValueError, match="power-of-two"):
            fbank.fft_audio_features(torch.zeros(1, 4000), cfg)


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
    for kernel in (fbank.fft_audio_features, fbank.dft_audio_features):
        with pytest.raises(ValueError, match="runs on cuda"):
            kernel(torch.zeros(2, 4000), cfg)
    launches = (fbank.fft_audio_features.launches, fbank.dft_audio_features.launches)
    fbank.audio_features(torch.zeros(2, 4000), cfg)
    assert launches == (fbank.fft_audio_features.launches, fbank.dft_audio_features.launches)
