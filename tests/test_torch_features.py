"""The port's audio front-end against the JAX package's, on the CPU.

Inputs come from numpy seeds and feed both packages. The CUDA kernels never
run here: on a CPU tensor their wrapper (``ops.cuda.fbank.audio_features``)
takes the plain version, which is what these tests hold against the JAX
package's XLA path (≤1e-4) and its Pallas kernels in interpret mode
(atol 2e-4 / rtol 1e-3, the bar of ``tests/test_pallas_features.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.ops import features as JF
from deeplip_tpu.ops import spectral as JS
from deeplip_tpu.ops.pallas.fbank_kernel import pallas_audio_features
from deeplip_tpu_torch.ops import features as TF
from deeplip_tpu_torch.ops import spectral as TS
from deeplip_tpu_torch.ops.cuda.fbank import audio_features, audio_features_reference
from deeplip_tpu_torch.ops.framing import samples_for_frames

torch.set_num_threads(1)

FRONT_ENDS = [
    ("mfcc", {"num_bin": 26, "num_cep": 24, "energy": True}),
    ("mfcc", {"num_bin": 26, "num_cep": 24, "energy": False}),
    ("fbank", {"num_bin": 24}),
    ("logfbank", {"num_bin": 60}),
]


def _sig(b=2, n=16000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) * 0.1).astype(np.float32)


def _port_kernel_path(sig: np.ndarray, cfg) -> np.ndarray:
    """The kernels' wrapper on raw PCM, as extract_features calls it."""
    return audio_features(torch.from_numpy(sig), cfg).numpy()


@pytest.mark.parametrize("name,args", [
    ("rdft_matrices", (400, 512)),
    ("rdft_matrices", (256, 256)),
    ("rdft_fused_matrix", (400, 512)),
    ("mel_filterbank", (26, 512, 16000)),
    ("mel_filterbank", (60, 512, 16000)),
    ("mel_filterbank", (40, 1024, 44100, 20.0, 8000.0)),
    ("dct_matrix", (24, 26)),
    ("dct_matrix", (13, 40)),
    ("cepstral_lifter", (24, 22)),
    ("cepstral_lifter", (13, 0)),
    ("hann_window", (400, True)),
    ("hann_window", (400, False)),
])
def test_spectral_arrays_byte_equal(name, args):
    want = getattr(JS, name)(*args)
    got = getattr(TS, name)(*args)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_mel_scale_byte_equal():
    hz = np.linspace(0.0, 8000.0, 97)
    assert TS.hz_to_mel(hz).tobytes() == JS.hz_to_mel(hz).tobytes()
    mel = JS.hz_to_mel(hz)
    assert TS.mel_to_hz(mel).tobytes() == JS.mel_to_hz(mel).tobytes()


@pytest.mark.parametrize("feat_type,kw", FRONT_ENDS + [
    ("mfcc", {"normalize": True, "delta": True}),
    ("mfcc", {"rate": 22050, "n_fft": 1024, "num_bin": 40, "num_cep": 13}),
])
def test_plain_front_end_matches_xla(feat_type, kw):
    kw = {"normalize": False, **kw}
    jcfg = JF.FeatureConfig(feat_type=feat_type, precision="highest", **kw)
    tcfg = TF.FeatureConfig(feat_type=feat_type, **kw)
    sig = _sig(seed=1)
    want = np.asarray(JF.extract_features(jnp.asarray(sig), jcfg))
    got = TF.extract_features(torch.from_numpy(sig), tcfg).numpy()
    plain = audio_features_reference(torch.from_numpy(sig), tcfg)
    if tcfg.normalize:
        plain = TF.cmvn(plain)
    if tcfg.delta:
        plain = TF.add_deltas(plain)
    plain = plain.numpy()
    assert got.shape == want.shape == plain.shape
    # 1e-4, absolute or relative: the lowest of 60 mel filters span one or
    # two bins next to DC, where the f32 DFT sum of pre-emphasised PCM
    # cancels; BLAS and XLA sum in other orders, which moves log-mel there
    # by up to ~5e-5 of its magnitude (~13).
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("feat_type,kw", FRONT_ENDS)
def test_fft_front_end_matches_jax_fft(feat_type, kw):
    """``dft='fft'``: the spectrum from ``torch.fft.rfft`` against the JAX
    package's from ``jnp.fft.rfft``, each pre-emphasised and masked at a
    ragged row length, at the kernels' bar."""
    jcfg = JF.FeatureConfig(feat_type=feat_type, normalize=False, dft="fft", **kw)
    tcfg = TF.FeatureConfig(feat_type=feat_type, normalize=False, dft="fft", **kw)
    sig = _sig(seed=5)
    lens = np.array([16000, 9001], np.int32)
    want = np.asarray(JF.extract_features(jnp.asarray(sig), jcfg,
                                          sample_lengths=jnp.asarray(lens)))
    got = TF.extract_features(torch.from_numpy(sig), tcfg,
                              sample_lengths=torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("version", ["v1", "auto"])
@pytest.mark.parametrize("feat_type,kw", FRONT_ENDS)
def test_kernel_path_matches_pallas_interpret(feat_type, kw, version):
    jcfg = JF.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
    tcfg = TF.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
    sig = _sig()
    want = np.asarray(pallas_audio_features(jnp.asarray(sig), jcfg, interpret=True,
                                            t_tile=32, version=version))
    got = _port_kernel_path(sig, tcfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("frames", [24, 200, 203, 331])
def test_kernel_path_matches_pallas_at_tile_boundaries(frames):
    jcfg = JF.FeatureConfig(feat_type="mfcc", normalize=False)
    tcfg = TF.FeatureConfig(feat_type="mfcc", normalize=False)
    n = samples_for_frames(frames, tcfg.win_len, tcfg.win_shift, tcfg.rate)
    sig = _sig(b=3, n=n, seed=frames)
    want = np.asarray(pallas_audio_features(jnp.asarray(sig), jcfg, interpret=True))
    got = _port_kernel_path(sig, tcfg)
    assert got.shape == want.shape == (3, frames, 24)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_sample_lengths_masked_batch_matches():
    """A ragged zero-padded batch with per-row lengths: pre-emphasis masked
    at each true length, as the JAX package does, and each row's valid
    frames equal exact-length extraction of that utterance."""
    rng = np.random.default_rng(7)
    lens = np.array([16000, 11111, 4000], np.int32)
    sig = np.zeros((3, 16000), np.float32)
    for i, n in enumerate(lens):
        sig[i, :n] = rng.standard_normal(n) * 0.1
    jcfg = JF.FeatureConfig(normalize=False, precision="highest")
    tcfg = TF.FeatureConfig(normalize=False)
    want = np.asarray(JF.extract_features(jnp.asarray(sig), jcfg,
                                          sample_lengths=jnp.asarray(lens)))
    got = TF.extract_features(torch.from_numpy(sig), tcfg,
                              sample_lengths=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for i, n in enumerate(lens):
        single = TF.extract_features(torch.from_numpy(sig[i, :n]), tcfg).numpy()
        np.testing.assert_allclose(got[i, : single.shape[0]], single,
                                   atol=1e-5, rtol=0)


def test_cmvn_and_deltas_match():
    rng = np.random.default_rng(11)
    feat = rng.standard_normal((2, 50, 24)).astype(np.float32)
    np.testing.assert_allclose(TF.cmvn(torch.from_numpy(feat)).numpy(),
                               np.asarray(JF.cmvn(jnp.asarray(feat))), atol=1e-5)
    np.testing.assert_allclose(TF.add_deltas(torch.from_numpy(feat)).numpy(),
                               np.asarray(JF.add_deltas(jnp.asarray(feat))), atol=1e-5)


@pytest.mark.parametrize("kw", [{"feat_type": "stft"}, {"dft": "matmul_fused"},
                                {"dft": "matmul_packed"}])
def test_unported_front_ends_raise(kw):
    cfg = TF.FeatureConfig(normalize=False, **kw)
    with pytest.raises(NotImplementedError):
        TF.extract_features(torch.zeros(1, 4000), cfg)


def test_feature_config_from_config_matches():
    opts = {"rate": 16000, "feat_type": "logfbank", "dft": "matmul",
            "logfbank": {"n_fft": 512, "num_bin": 40, "normalize": False,
                         "win_len": 0.025, "win_shift": 0.01}}
    j = JF.FeatureConfig.from_config(opts)
    t = TF.FeatureConfig.from_config(opts)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert TF.feature_dim(t) == JF.feature_dim(j)
    assert (t.frame_len, t.frame_step) == (j.frame_len, j.frame_step)
