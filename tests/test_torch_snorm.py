"""AS-norm and the fusion scoring back-ends of the port against the JAX
package's on seeded embeddings and cohorts. 1e-5: unit-norm dot products and
z-scores of O(1-10) in f32, with another accumulation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.eval import scoring as JS
from deeplip_tpu.eval import snorm as JN
from deeplip_tpu_torch.eval import scoring as S
from deeplip_tpu_torch.eval import snorm as N

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed=0, n=12, c=30, d=16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32) * 2.0
    cohort = rng.standard_normal((c, d)).astype(np.float32)
    pairs = rng.integers(0, n, (40, 2)).astype(np.int32)
    return emb, cohort, pairs


@pytest.mark.parametrize("top_k", [5, 30, 200])
def test_cohort_topk_stats_match(top_k):
    emb, cohort, _ = _data()
    want_mu, want_sd = JN.cohort_topk_stats(jnp.asarray(emb), jnp.asarray(cohort), top_k)
    mu, sd = N.cohort_topk_stats(torch.from_numpy(emb), torch.from_numpy(cohort), top_k)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), **TOL)
    np.testing.assert_allclose(sd.numpy(), np.asarray(want_sd), **TOL)
    if top_k >= 30:   # clamped to the cohort size: plain S-norm statistics
        unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
        scores = unit(emb) @ unit(cohort).T
        np.testing.assert_allclose(mu.numpy(), scores.mean(-1), **TOL)
        np.testing.assert_allclose(sd.numpy(), scores.std(-1), **TOL)


def test_asnorm_from_stats_matches():
    rng = np.random.default_rng(1)
    raw = rng.standard_normal(40).astype(np.float32)
    mu = rng.standard_normal(12).astype(np.float32)
    sd = rng.uniform(0.1, 1.0, 12).astype(np.float32)
    pairs = _data()[2]
    want = JN.asnorm_from_stats(jnp.asarray(raw), jnp.asarray(pairs), jnp.asarray(mu),
                                jnp.asarray(sd))
    got = N.asnorm_from_stats(torch.from_numpy(raw), torch.from_numpy(pairs).long(),
                              torch.from_numpy(mu), torch.from_numpy(sd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cohort_matrix_coercions():
    _, cohort, _ = _data()
    store, jstore = S.EmbeddingStore(), JS.EmbeddingStore()
    for i, row in enumerate(cohort):
        store[f"c{i}"] = row
        jstore[f"c{i}"] = row
    for given in (cohort, torch.from_numpy(cohort), store, dict(store.table),
                  {k: v.numpy() for k, v in store.table.items()}):
        m = N.cohort_matrix(given)
        assert isinstance(m, np.ndarray) and m.dtype == np.float32
        np.testing.assert_array_equal(m, JN.cohort_matrix(jstore))
    with pytest.raises(ValueError, match=r"\(C, D\)"):
        N.cohort_matrix(cohort[0])


@pytest.mark.parametrize("top_k", [4, 200])
def test_asnorm_trial_scores_and_numpy_twin(top_k):
    emb, cohort, pairs = _data(seed=2)
    want = JN.asnorm_trial_scores(emb, pairs, cohort, top_k)
    got = N.asnorm_trial_scores(emb, pairs, cohort, top_k, device="cpu")
    twin = N.asnorm_trial_scores_np(emb, pairs, cohort, top_k)
    assert isinstance(got, np.ndarray) and got.shape == (40,)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(twin, got, **TOL)
    np.testing.assert_allclose(twin, JN.asnorm_trial_scores_np(emb, pairs, cohort, top_k),
                               rtol=0, atol=1e-6)
    # a tensor on the device is taken as it is
    np.testing.assert_allclose(
        N.asnorm_trial_scores(torch.from_numpy(emb), pairs, cohort, top_k, device="cpu"), got,
        rtol=0, atol=0)


def test_degenerate_cohort_stays_finite():
    emb, _, pairs = _data(seed=3)
    cohort = np.tile(np.ones((1, 16), np.float32), (6, 1))   # every cohort score equal
    for scores in (N.asnorm_trial_scores(emb, pairs, cohort, 3, device="cpu"),
                   N.asnorm_trial_scores_np(emb, pairs, cohort, 3)):
        assert np.all(np.isfinite(scores))
    mu, sd = N.cohort_topk_stats(torch.from_numpy(emb), torch.from_numpy(cohort), 3)
    assert float(sd.min()) >= np.float32(1e-12)


def _stores(seed=4, n_spk=4, per=3, d=12):
    """Names, trial lists of both packages and (audio, video) stores of
    both, from one seeded set of speaker-clustered embeddings."""
    rng = np.random.default_rng(seed)
    names = [f"s{s}/u{u}.wav" for s in range(n_spk) for u in range(per)]
    centres = rng.standard_normal((2, n_spk, d)) * 2.0
    stores = [(S.EmbeddingStore(), JS.EmbeddingStore()) for _ in range(2)]
    for m, (ts, js) in enumerate(stores):
        for name in names:
            v = (centres[m, int(name[1])] + rng.standard_normal(d)).astype(np.float32)
            ts[name], js[name] = v, v
    labels, u1, u2 = [], [], []
    for a in range(len(names)):
        for b in range(a + 1, len(names)):
            labels.append(int(names[a][:2] == names[b][:2]))
            u1.append(names[a])
            u2.append(names[b])
    labels = np.asarray(labels, np.int8)
    return S.TrialList(labels, u1, u2), JS.TrialList(labels, u1, u2), stores


def test_asnorm_eer_matches():
    trials, jtrials, ((audio, jaudio), _) = _stores()
    cohort = _data(seed=5, d=12)[1]
    want = JN.asnorm_eer(jtrials, jaudio, cohort, top_k=10)
    got = N.asnorm_eer(trials, audio, cohort, top_k=10, device="cpu")
    assert got == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("weights", [(0.5, 0.5), (0.8, 0.2)])
def test_score_fusion_eer_matches(weights):
    trials, jtrials, ((audio, jaudio), (video, jvideo)) = _stores(seed=6)
    want = JS.score_fusion_eer(jtrials, jaudio, jvideo, *weights)
    got = S.score_fusion_eer(trials, audio, video, *weights, device="cpu")
    assert got == pytest.approx(want, abs=1e-5)
    assert 0.0 <= got[0] <= 1.0


def test_feature_fusion_eer_and_normalize_match():
    trials, jtrials, ((audio, jaudio), (video, jvideo)) = _stores(seed=7)
    v = audio["s0/u0.wav"].numpy()
    np.testing.assert_array_equal(S.feature_normalize(v), JS.feature_normalize(v))
    want = JS.feature_fusion_eer(jtrials, jaudio, jvideo)
    got = S.feature_fusion_eer(trials, audio, video, device="cpu")
    assert got == pytest.approx(want, abs=1e-5)
