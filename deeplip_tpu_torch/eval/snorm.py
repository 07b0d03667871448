"""Adaptive score normalization (AS-norm) for verification scoring.

Counterpart of ``deeplip_tpu/eval/snorm.py``. Each trial score is
normalised against an impostor cohort so that one decision threshold stays
calibrated across recording conditions (top-K adaptive S-norm, "AS-norm1":
Matejka et al., Interspeech 2017). For a trial ``(e, t)`` with raw cosine
``s``:

    s' = 0.5 * ((s - mu_e) / sd_e  +  (s - mu_t) / sd_t)

where ``mu_e, sd_e`` are the mean and population std of ``e``'s top-K cohort
cosines. Every utterance-vs-cohort cosine comes from one ``(N, D) x (D, C)``
FP32 matmul, the top-K from one ``torch.topk`` and the per-trial
normalisation from a gather: no per-trial or per-cohort loops. With
``top_k >= C`` this is plain S-norm.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplip_tpu_torch.core.device import fp32_math, resolve_device
from deeplip_tpu_torch.eval.eer import eer_from_scores
from deeplip_tpu_torch.eval.scoring import (EmbeddingStore, TrialList, cosine_scores,
                                            cosine_scores_np, trial_matrix_pairs)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def cohort_topk_stats(embeddings: torch.Tensor, cohort: torch.Tensor,
                      top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-embedding ``(mu, sd)`` of its ``top_k`` cohort cosines.

    ``embeddings (N, D)``, ``cohort (C, D)`` (any norm; both are
    L2-normalised here) -> two ``(N,)`` vectors. ``top_k`` is clamped to
    ``C``. ``sd`` is the population std, floored at 1e-12 so a degenerate
    cohort (all scores equal) gives no inf or NaN. The matmul is pinned to
    FP32: ``sd`` is a small difference of clustered cohort scores.
    """
    k = min(int(top_k), cohort.shape[0])
    with fp32_math():
        scores = _unit(embeddings) @ _unit(cohort).T
    top = torch.topk(scores, k, dim=-1).values
    mu = top.mean(dim=-1)
    sd = torch.sqrt(torch.mean(torch.square(top - mu[:, None]), dim=-1))
    return mu, sd.clamp(min=1e-12)


def asnorm_from_stats(raw_scores: torch.Tensor, pairs: torch.Tensor,
                      mu: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    """Normalise ``(M,)`` raw pair scores with per-utterance cohort stats,
    gathered through the ``(M, 2)`` ``pairs`` indices."""
    mu_a, mu_b = mu[pairs[:, 0]], mu[pairs[:, 1]]
    sd_a, sd_b = sd[pairs[:, 0]], sd[pairs[:, 1]]
    return 0.5 * ((raw_scores - mu_a) / sd_a + (raw_scores - mu_b) / sd_b)


def cohort_matrix(cohort) -> np.ndarray:
    """Coerce a cohort, a ``(C, D)`` array or tensor, an
    :class:`EmbeddingStore` or a ``{name: vec}`` mapping, to a float32
    matrix on the host."""
    if isinstance(cohort, EmbeddingStore):
        cohort = cohort.table
    if isinstance(cohort, dict):
        return np.stack([torch.as_tensor(v).detach().cpu().numpy().reshape(-1)
                         for v in cohort.values()]).astype(np.float32)
    if isinstance(cohort, torch.Tensor):
        cohort = cohort.detach().cpu().numpy()
    m = np.asarray(cohort, np.float32)
    if m.ndim != 2:
        raise ValueError(f"cohort must be (C, D); got shape {m.shape}")
    return m


def asnorm_trial_scores(emb, pairs, cohort, top_k: int = 200,
                        device: str | torch.device | None = None) -> np.ndarray:
    """AS-normed cosine scores for ``(N, D)`` embeddings over ``(M, 2)``
    trial index pairs, computed on ``device`` (default: the card)."""
    dev = resolve_device(device)
    e = torch.as_tensor(emb).to(dev, torch.float32)
    p = torch.as_tensor(np.asarray(pairs, np.int64)).to(dev)
    raw = cosine_scores(e, p)
    mu, sd = cohort_topk_stats(e, torch.from_numpy(cohort_matrix(cohort)).to(dev), top_k)
    return asnorm_from_stats(raw, p, mu, sd).cpu().numpy()


def asnorm_trial_scores_np(emb: np.ndarray, pairs: np.ndarray, cohort,
                           top_k: int = 200) -> np.ndarray:
    """Host (numpy float32) twin of :func:`asnorm_trial_scores`: the same
    formulas with the top-K through ``np.partition``, for batch-1 serving,
    where the scoring is a few dot products. Agrees with the tensor path to
    f32 roundoff."""
    e = np.asarray(emb, np.float32)
    p = np.asarray(pairs)
    raw = cosine_scores_np(e, p)
    c = cohort_matrix(cohort)
    k = min(int(top_k), c.shape[0])
    eu = e / np.linalg.norm(e, axis=-1, keepdims=True).clip(1e-12)
    cu = c / np.linalg.norm(c, axis=-1, keepdims=True).clip(1e-12)
    scores = eu @ cu.T
    top = -np.partition(-scores, k - 1, axis=-1)[:, :k]
    mu = np.mean(top, axis=-1)
    sd = np.maximum(np.sqrt(np.mean(np.square(top - mu[:, None]), axis=-1)), 1e-12)
    mu_a, mu_b = mu[p[:, 0]], mu[p[:, 1]]
    sd_a, sd_b = sd[p[:, 0]], sd[p[:, 1]]
    return 0.5 * ((raw - mu_a) / sd_a + (raw - mu_b) / sd_b)


def asnorm_eer(trials: TrialList, store: EmbeddingStore, cohort, top_k: int = 200,
               device: str | torch.device | None = None) -> tuple[float, float]:
    """Trial-list EER and threshold over AS-normed scores."""
    emb, pairs = trial_matrix_pairs(trials, store)
    return eer_from_scores(trials.labels,
                           asnorm_trial_scores(emb, pairs, cohort, top_k, device))
