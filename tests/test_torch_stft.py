"""The port's ``stft`` front-end and ``dft`` names against the JAX package's.

- ``stft_features`` with and without ``sample_lengths`` against
  ``deeplip_tpu.ops.features.stft_features`` (bar 1e-4), at odd and even
  widths and a row shorter than ``n_fft / 2`` (several reflect folds);
- with lengths, each row's first ``1 + L // hop`` frames bit-equal to that
  utterance extracted alone (the JAX package's agree to its matmul's
  blocking, ~2e-6, on the CPU);
- ``extract_features`` with ``stft`` and CMVN, and ``feature_dim``;
- the ``dft`` names: ``matmul_fused`` and ``matmul_packed`` compute what
  ``matmul`` does, bit for bit in the port and within 1e-4 of the JAX
  package's own bases, on every front-end; an unknown name raises;
- the extractor's ``stft`` path: librosa's column count as each row's valid
  length, so a padded batch embeds each utterance as it embeds alone.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.ops import features as JF
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.ops import features as TF
from deeplip_tpu_torch.train.audio import AudioExtractor, valid_feature_lengths

torch.set_num_threads(1)

STFT = dict(feat_type="stft", n_fft=512, normalize=False, delta=False, win_len=0.025,
            win_shift=0.01)


def _pcm(lengths, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.standard_normal(n).astype(np.float32) * 0.3
    return out


@pytest.mark.parametrize("dft", ["matmul", "fft"])
@pytest.mark.parametrize("width", [4000, 4321])
def test_stft_matches_jax(width, dft):
    cfg_j = JF.FeatureConfig(**STFT, dft=dft)
    cfg_t = TF.FeatureConfig(**STFT, dft=dft)
    x = _pcm([width, width - 777, 150])
    want = np.asarray(JF.stft_features(jnp.asarray(x), cfg_j))
    got = TF.stft_features(torch.from_numpy(x), cfg_t).numpy()
    assert got.shape == want.shape == (3, 1 + width // 160, 257)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    lens = np.array([width, width - 777, 150], np.int32)
    want = np.asarray(JF.stft_features(jnp.asarray(x), cfg_j, sample_lengths=jnp.asarray(lens)))
    got = TF.stft_features(torch.from_numpy(x), cfg_t,
                           sample_lengths=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_stft_rows_with_lengths_equal_each_utterance_alone():
    cfg = TF.FeatureConfig(**STFT)
    lens = [3200, 2881, 1000, 200]
    x = _pcm(lens, seed=1)
    batch = TF.stft_features(torch.from_numpy(x), cfg,
                             sample_lengths=torch.tensor(lens))
    for i, n in enumerate(lens):
        alone = TF.stft_features(torch.from_numpy(x[i:i + 1, :n]), cfg)[0]
        n_valid = 1 + n // TF.stft_hop(cfg)
        assert alone.shape[0] == n_valid
        assert torch.equal(batch[i, :n_valid], alone), f"row {i}"
    # the JAX package's rows agree with its utterance alone only to its
    # matmul's blocking on this host (~2e-6), and with the port's to 1e-4
    jcfg = JF.FeatureConfig(**STFT)
    jb = np.asarray(JF.stft_features(jnp.asarray(x), jcfg, sample_lengths=jnp.asarray(lens)))
    ja = np.asarray(JF.stft_features(jnp.asarray(x[1:2, :lens[1]]), jcfg))[0]
    np.testing.assert_allclose(jb[1, :ja.shape[0]], ja, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(batch.numpy(), jb, atol=1e-4, rtol=1e-4)


def test_extract_features_stft_with_cmvn_matches_jax():
    opts = {"rate": 16000, "feat_type": "stft", "stft": {
        "n_fft": 512, "normalize": True, "delta": False, "win_len": 0.025, "win_shift": 0.01}}
    cfg_t, cfg_j = TF.FeatureConfig.from_config(opts), JF.FeatureConfig.from_config(opts)
    assert TF.feature_dim(cfg_t) == JF.feature_dim(cfg_j) == 257
    x = _pcm([4800, 4800], seed=2)
    got = TF.extract_features(torch.from_numpy(x), cfg_t).numpy()
    want = np.asarray(JF.extract_features(jnp.asarray(x), cfg_j))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("feat_type", ["mfcc", "fbank", "logfbank", "stft"])
def test_dft_names_compute_the_matmul_front_end(feat_type):
    x = _pcm([4000, 3500], seed=3)
    base = dict(feat_type=feat_type, normalize=False, num_bin=26 if feat_type != "logfbank"
                else 40)
    want = TF.extract_features(torch.from_numpy(x), TF.FeatureConfig(**base, dft="matmul"))
    for name in ("matmul_fused", "matmul_packed"):
        got = TF.extract_features(torch.from_numpy(x), TF.FeatureConfig(**base, dft=name))
        assert torch.equal(got, want), name
        jax_own = np.asarray(JF.extract_features(jnp.asarray(x),
                                                 JF.FeatureConfig(**base, dft=name)))
        np.testing.assert_allclose(got.numpy(), jax_own, atol=1e-4, rtol=1e-4, err_msg=name)
    with pytest.raises(NotImplementedError, match="dft"):
        TF.extract_features(torch.from_numpy(x), TF.FeatureConfig(**base, dft="bogus"))


def test_extractor_embeds_a_padded_stft_batch_as_each_utterance_alone():
    cfg = Config({
        "model": {"arch": "tdnn", "tdnn": {
            "input_dim": 257, "hidden_dim": [16, 16], "context": [[-2, 0, 2], [0]],
            "tdnn_layers": 2, "embedding_dim": 8, "pooling": "attentive_statistic",
            "attention_hidden_size": 4, "bn_first": True}},
        "data": {"python_data_config": {"rate": 16000, "feat_type": "stft", "stft": {
            "n_fft": 512, "normalize": True, "delta": False, "win_len": 0.025,
            "win_shift": 0.01}}}})
    torch.manual_seed(0)
    ext = AudioExtractor(cfg, device="cpu")
    lens = [4000, 2500]
    x = torch.from_numpy(_pcm(lens, seed=4))
    sample_lengths = torch.tensor(lens, dtype=torch.int32)
    # the pipeline's buckets count mel frames; the stft path counts librosa's
    feat_lengths = torch.tensor([24, 15], dtype=torch.int32)
    feats = TF.extract_features(x, ext.eval_feat_cfg, sample_lengths=sample_lengths)
    assert valid_feature_lengths(feats, feat_lengths, sample_lengths,
                                 ext.feat_cfg).tolist() == [26, 16]
    both = ext.embed(x, feat_lengths, sample_lengths)
    for i, n in enumerate(lens):
        alone = ext.embed(x[i:i + 1, :n], feat_lengths[i:i + 1], sample_lengths[i:i + 1])
        np.testing.assert_allclose(both[i].numpy(), alone[0].numpy(), atol=1e-5, rtol=1e-5)
    mel = dataclasses.replace(ext.feat_cfg, feat_type="mfcc")
    assert valid_feature_lengths(feats, feat_lengths, sample_lengths, mel) is feat_lengths
