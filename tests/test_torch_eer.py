"""The port's EER functions are bit-equal to the JAX package's.

The JAX package computes the reference EER with sklearn's ``roc_curve``;
the port carries its own numpy ``roc_curve`` (the card has no sklearn).
Both then use scipy's ``brentq``/``interp1d``, so equal ROC arrays give
bit-equal EERs.
"""

import numpy as np
import pytest
import torch

from deeplip_tpu.eval import eer as JE
from deeplip_tpu_torch.eval import eer as TE

torch.set_num_threads(1)


def _random(seed, n=4000):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = (rng.standard_normal(n) + 1.2 * labels).astype(np.float32)
    return labels, scores


def _tied(seed, n=4000):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    # a handful of distinct values: long runs of tied scores of both labels
    scores = np.round(rng.standard_normal(n) + labels, 1).astype(np.float32)
    return labels, scores


CASES = [("random", s) for s in range(3)] + [("tied", s) for s in range(3)]


def _case(kind, seed):
    return _random(seed) if kind == "random" else _tied(seed)


@pytest.mark.parametrize("kind,seed", CASES)
def test_roc_curve_equals_sklearn(kind, seed):
    from sklearn.metrics import roc_curve

    labels, scores = _case(kind, seed)
    want = roc_curve(labels, scores, pos_label=1)
    got = TE.roc_curve(labels, scores)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind,seed", CASES)
def test_eer_from_scores_bit_equal(kind, seed):
    labels, scores = _case(kind, seed)
    assert TE.eer_from_scores(labels, scores) == JE.eer_from_scores(labels, scores)


@pytest.mark.parametrize("kind,seed", CASES)
def test_eer_sweep_bit_equal(kind, seed):
    labels, scores = _case(kind, seed)
    assert TE.eer_sweep(labels, scores) == JE.eer_sweep(labels, scores)


def test_perfectly_separated_scores():
    labels = np.array([0, 0, 0, 1, 1, 1])
    scores = np.array([0.1, 0.2, 0.3, 0.7, 0.8, 0.9], np.float32)
    assert TE.eer_from_scores(labels, scores) == JE.eer_from_scores(labels, scores)
