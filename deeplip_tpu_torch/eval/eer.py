"""Equal error rate computation (numpy + scipy, no sklearn).

Counterpart of ``deeplip_tpu/eval/eer.py``:

- :func:`eer_from_scores` is the reference formula: a ROC curve, then
  ``brentq(1 - x - interp1d(fpr, tpr)(x))`` and the threshold interpolated
  at the EER. :func:`roc_curve` reproduces sklearn's ``roc_curve`` (binary
  labels, ``pos_label=1``, ``drop_intermediate=True``, ``thresholds[0] =
  inf``, ties merged into one operating point), so the result is bit-equal
  to the JAX package's sklearn-based one.
- :func:`eer_sweep` is the exact FAR/FRR crossing, with no interpolation.
"""

from __future__ import annotations

import numpy as np


def roc_curve(y_true, y_score) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(fpr, tpr, thresholds)`` of sklearn's ``roc_curve(y_true, y_score,
    pos_label=1)`` for binary labels."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    if not np.all(np.isfinite(y_score)):
        raise ValueError("scores must be finite")
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order].astype(np.float64)
    # the last index of each run of tied scores, plus the curve's end
    distinct = np.nonzero(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    thresholds = y_score[threshold_idxs]
    if fps.shape[0] > 2:
        # drop points collinear with their neighbours (drop_intermediate)
        keep = np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def eer_from_scores(y_true, y_score) -> tuple[float, float]:
    """Reference-exact EER: returns ``(eer, threshold)``."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    fpr, tpr, thresholds = roc_curve(y_true, y_score)
    eer = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)
    threshold = float(interp1d(fpr, thresholds)(eer))
    return float(eer), threshold


def eer_sweep(y_true, y_score) -> tuple[float, float]:
    """Exact EER from the FAR/FRR curves: at each realizable threshold (the
    last index of a tied-score run), FAR = FP/N and FRR = FN/P; returns the
    mean of FAR and FRR where ``|FAR - FRR|`` is least, and that score."""
    y_true = np.asarray(y_true).reshape(-1).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64).reshape(-1)
    order = np.argsort(-y_score)
    scores = y_score[order]
    labels = y_true[order]
    p = labels.sum()
    n = len(labels) - p
    tp = np.cumsum(labels)
    fp = np.cumsum(~labels)
    far = fp / max(n, 1)
    frr = 1.0 - tp / max(p, 1)
    realizable = np.ones(len(scores), bool)
    realizable[:-1] = np.diff(scores) != 0
    cand = np.nonzero(realizable)[0]
    idx = int(cand[np.argmin(np.abs(far[cand] - frr[cand]))])
    eer = float(0.5 * (far[idx] + frr[idx]))
    return eer, float(scores[idx])
