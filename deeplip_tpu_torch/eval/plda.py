"""Probabilistic LDA back-end for verification scoring.

A numpy copy of ``deeplip_tpu/eval/plda.py`` (which the port cannot
import: the JAX package's ``eval`` pulls in JAX); :func:`plda_eer` scores
through the port's own ``trial_matrix_pairs`` and ``eer_from_scores``.

The reference delegates to the ``plda`` PyPI package: it fits on LOMGRID dev
x-vectors with ``n_principal_components=20`` (``train_audio.py:339-341``),
transforms trial embeddings ``D -> U_model`` and scores with the same/diff
log-likelihood ratio (``models/audio_models/utils.py:296-301``). This module
is a fresh implementation of that model — Ioffe's "Probabilistic Linear
Discriminant Analysis" (ECCV 2006) with the closed-form ML fit:

1. optional PCA to ``n_principal_components``;
2. between/within scatter ``S_b``, ``S_w`` from class means;
3. simultaneous diagonalization (whiten ``S_w``, eigendecompose whitened
   ``S_b``) giving the loading matrix ``A`` and prior variances
   ``Ψ = max(0, (n-1)/n · λ_b - 1/n)``;
4. latent projection ``u = A^{-1}(x - m)`` where within-class noise is
   standard normal and class centers are ``N(0, diag(Ψ))``.

Fit internals (mean, Ψ), latent axes, per-trial LLRs and the protocol EER
are held against a vendored reconstruction of the ``plda`` package
(``tests/third_party/plda``) and against the JAX package's module
(``tests/test_torch_plda.py``), including the degenerate
``rank(S_b) < n_principal_components`` case (zero-Ψ dims).

Scoring is the exact two-point LLR, vectorized over trial pairs (one
elementwise pass — no per-trial Python loop):

    llr(u, v) = Σ_d [ log N₂((u_d, v_d); 0, [[ψ+1, ψ], [ψ, ψ+1]])
                      - log N(u_d; 0, ψ+1) - log N(v_d; 0, ψ+1) ]
"""

from __future__ import annotations

from dataclasses import dataclass

import os

import numpy as np


@dataclass
class PLDA:
    mean: np.ndarray | None = None  # (D,)
    pca: np.ndarray | None = None  # (D, P) principal axes (or None)
    inv_a: np.ndarray | None = None  # (P, P) latent projection A^{-1}
    psi: np.ndarray | None = None  # (P,) prior variances

    def fit(
        self, x: np.ndarray, labels: np.ndarray, n_principal_components: int | None = None
    ) -> "PLDA":
        x = np.asarray(x, np.float64)
        labels = np.asarray(labels)
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        if n_principal_components is not None and n_principal_components < x.shape[1]:
            # PCA via SVD of centered data
            _, _, vt = np.linalg.svd(xc, full_matrices=False)
            self.pca = vt[:n_principal_components].T  # (D, P)
            xc = xc @ self.pca
        else:
            self.pca = None

        classes, inv = np.unique(labels, return_inverse=True)
        k = len(classes)
        n_total, d = xc.shape
        counts = np.bincount(inv).astype(np.float64)
        sums = np.zeros((k, d))
        np.add.at(sums, inv, xc)
        means = sums / counts[:, None]
        centered = xc - means[inv]
        s_w = centered.T @ centered / n_total
        s_b = (means * counts[:, None]).T @ means / n_total

        # simultaneous diagonalization: whiten S_w, diagonalize whitened S_b
        w_val, w_vec = np.linalg.eigh(s_w)
        w_val = np.maximum(w_val, 1e-10)
        whiten = w_vec / np.sqrt(w_val)  # (d, d): whiten.T @ s_w @ whiten = I
        b_val, b_vec = np.linalg.eigh(whiten.T @ s_b @ whiten)

        n_avg = counts.mean()
        # latent loading: x - m = A u with u ~ N(center, I), center ~ N(0, Ψ)
        a = np.linalg.inv((whiten @ b_vec).T) * np.sqrt(n_avg / (n_avg - 1.0))
        self.inv_a = np.linalg.inv(a)
        self.psi = np.maximum(
            (n_avg - 1.0) / n_avg * b_val - 1.0 / n_avg, 0.0
        )
        return self

    # ---- projection ---------------------------------------------------
    def transform(self, x: np.ndarray) -> np.ndarray:
        """``D -> U`` latent projection (≙ the package's ``D → U_model``)."""
        xc = np.asarray(x, np.float64) - self.mean
        if self.pca is not None:
            xc = xc @ self.pca
        return xc @ self.inv_a.T

    # ---- scoring ------------------------------------------------------
    def llr(self, u1: np.ndarray, u2: np.ndarray) -> np.ndarray:
        """Batched same/diff LLR for latent pairs ``(..., P)``."""
        psi = self.psi
        var = psi + 1.0
        # log N2 with cov [[v, ψ], [ψ, v]]: det = v² - ψ², inverse closed form
        det2 = var * var - psi * psi
        quad_same = (
            var * (u1 * u1 + u2 * u2) - 2.0 * psi * u1 * u2
        ) / det2
        ll_same = -0.5 * (np.log(2 * np.pi) * 2 + np.log(det2) + quad_same)
        ll_diff = -0.5 * (
            2 * np.log(2 * np.pi) + 2 * np.log(var) + (u1 * u1 + u2 * u2) / var
        )
        return np.sum(ll_same - ll_diff, axis=-1)

    def score_pairs(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        return self.llr(self.transform(x1), self.transform(x2))

    # ---- persistence --------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(
            path,
            mean=self.mean,
            pca=self.pca if self.pca is not None else np.zeros((0, 0)),
            inv_a=self.inv_a,
            psi=self.psi,
        )

    @classmethod
    def load(cls, path: str) -> "PLDA":
        # np.savez silently appends '.npz' to suffix-less paths: accept both
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path)
        pca = z["pca"]
        return cls(
            mean=z["mean"],
            pca=None if pca.size == 0 else pca,
            inv_a=z["inv_a"],
            psi=z["psi"],
        )


def plda_eer(trials, store, model: PLDA):
    """PLDA back-end EER over a trial list (≙ ``eer_plda_*``)."""
    from deeplip_tpu_torch.eval.eer import eer_from_scores
    from deeplip_tpu_torch.eval.scoring import trial_matrix_pairs

    emb, pairs = trial_matrix_pairs(trials, store)
    # the embeddings come to the host for the float64 scoring
    latent = model.transform(emb.detach().cpu().numpy())
    scores = model.llr(latent[pairs[:, 0]], latent[pairs[:, 1]])
    return eer_from_scores(trials.labels, scores)
