"""The port's PLDA back-end against the JAX package's and the vendored
``plda`` package reconstruction (``tests/third_party/plda``).

On LOMGRID-dev-shaped synthetic data (PCA 20 below the embedding width,
fewer speakers than latent dims, and no PCA) the port's fit equals the JAX
package's (mean, PCA axes, projection, Ψ to 1e-12) and scores the same
LLRs; against the oracle, Ψ and the mean agree and the per-trial LLRs agree
to 1e-8 relative, with the protocol EER equal.
"""

import numpy as np
import pytest
import torch

from deeplip_tpu.eval.eer import eer_from_scores as jax_eer
from deeplip_tpu.eval.plda import PLDA as JaxPLDA
from deeplip_tpu.eval.plda import plda_eer as jax_plda_eer
from deeplip_tpu.eval.scoring import EmbeddingStore as JaxStore
from deeplip_tpu.eval.scoring import TrialList as JaxTrials
from deeplip_tpu_torch.eval.eer import eer_from_scores
from deeplip_tpu_torch.eval.plda import PLDA, plda_eer
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList
from tests.third_party import plda as plda_pkg

torch.set_num_threads(1)

SHAPES = [(24, 64, 20), (12, 64, 20), (10, 16, None)]


def _dev_eval(n_spk, dim, seed, utts_per_spk=15, n_eval_spk=10, n_pairs=400):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((n_spk + n_eval_spk, dim))
    within = rng.standard_normal((dim, dim)) * 0.1 + np.eye(dim) * 0.6

    def draw(s, n):
        return centers[s] + rng.standard_normal((n, dim)) @ within

    dev_x = np.concatenate([draw(s, utts_per_spk) for s in range(n_spk)])
    dev_y = np.repeat(np.arange(n_spk), utts_per_spk)
    eval_x = np.concatenate([draw(n_spk + s, 4) for s in range(n_eval_spk)])
    eval_spk = np.repeat(np.arange(n_eval_spk), 4)
    pairs = rng.integers(0, len(eval_x), (n_pairs, 2))
    labels = (eval_spk[pairs[:, 0]] == eval_spk[pairs[:, 1]]).astype(np.int8)
    return dev_x, dev_y, eval_x, pairs, labels


@pytest.mark.parametrize("n_spk,dim,n_pc", SHAPES)
def test_plda_fit_and_scores_equal_jax(n_spk, dim, n_pc):
    dev_x, dev_y, eval_x, pairs, _ = _dev_eval(n_spk, dim, seed=n_spk)
    ours = PLDA().fit(dev_x, dev_y, n_principal_components=n_pc)
    ref = JaxPLDA().fit(dev_x, dev_y, n_principal_components=n_pc)
    for name in ("mean", "pca", "inv_a", "psi"):
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(ours.score_pairs(eval_x[pairs[:, 0]], eval_x[pairs[:, 1]]),
                               ref.score_pairs(eval_x[pairs[:, 0]], eval_x[pairs[:, 1]]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_spk,dim,n_pc", SHAPES)
def test_plda_matches_package_oracle(n_spk, dim, n_pc):
    dev_x, dev_y, eval_x, pairs, labels = _dev_eval(n_spk, dim, seed=42 + n_spk)
    clf = plda_pkg.Classifier()
    clf.fit_model(dev_x, dev_y, n_principal_components=n_pc)
    ours = PLDA().fit(dev_x, dev_y, n_principal_components=n_pc)
    mean = clf.model.pca.mean_ if n_pc is not None and n_pc < dim else clf.model.m
    np.testing.assert_allclose(ours.mean, mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.psi, clf.model.Psi.diagonal(), rtol=1e-6, atol=1e-8)
    u_model = clf.model.transform(eval_x, from_space="D", to_space="U_model")
    want = np.array([clf.model.calc_same_diff_log_likelihood_ratio(
        u_model[i][None], u_model[j][None]) for i, j in pairs])
    got = ours.score_pairs(eval_x[pairs[:, 0]], eval_x[pairs[:, 1]])
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) < 1e-8
    assert eer_from_scores(labels, got)[0] == eer_from_scores(labels, want)[0]


def test_plda_eer_and_persistence_equal_jax(tmp_path):
    dev_x, dev_y, eval_x, pairs, labels = _dev_eval(16, 32, seed=3)
    names = [f"u{i}" for i in range(len(eval_x))]
    lines = [f"{lab} {names[a]} {names[b]}" for (a, b), lab in zip(pairs, labels)]
    path = tmp_path / "trials.txt"
    path.write_text("\n".join(lines) + "\n")
    store, jstore = EmbeddingStore(), JaxStore()
    for n, x in zip(names, eval_x):
        store[n] = torch.tensor(x, dtype=torch.float32)
        jstore[n] = x.astype(np.float32)
    model = PLDA().fit(dev_x, dev_y, n_principal_components=20)
    got = plda_eer(TrialList.load(str(path)), store, model)
    want = jax_plda_eer(JaxTrials.load(str(path)), jstore,
                        JaxPLDA().fit(dev_x, dev_y, n_principal_components=20))
    assert got == want
    model.save(str(tmp_path / "plda_model"))      # np.savez adds .npz; load takes both
    again = PLDA.load(str(tmp_path / "plda_model"))
    assert plda_eer(TrialList.load(str(path)), store, again) == got
    assert jax_eer(labels, model.score_pairs(eval_x[pairs[:, 0]], eval_x[pairs[:, 1]]))[0] \
        == eer_from_scores(labels, model.score_pairs(eval_x[pairs[:, 0]],
                                                     eval_x[pairs[:, 1]]))[0]
