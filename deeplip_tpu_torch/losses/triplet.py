"""Online triplet losses with in-batch mining as masked reductions.

Counterpart of ``deeplip_tpu/losses/triplet.py``. Mining is a set of masks
over the batch's ``B x B`` cosine matrix, with no host loop and no
data-dependent shapes:

- ``batch_all``: every valid (a, p, n), mean hinge;
- ``batch_hard``: per (a, p) pair, the anchor's hardest negative, counted
  where its hinge is positive;
- ``semihard``: negatives with ``0 < loss < margin``.

A hinge is ``relu(cos(a, n) - cos(a, p) + margin)``: higher cosine means
more similar. Every function returns ``(loss, count)``.

Under a mesh (data-parallel training) the JAX step mines over the global
batch; :class:`OnlineTripletLoss` then gathers every rank's embeddings and
labels first (``core.mesh.Mesh.gather_rows``). The gather's backward
returns this rank's slice of the gradient without summing it: every rank
computes the same loss of the whole batch, and the trainer's one gradient
all-reduce counts each row once.
"""

from __future__ import annotations

from typing import Literal

import torch


def _cosine_matrix(embeddings: torch.Tensor) -> torch.Tensor:
    e = embeddings / torch.linalg.vector_norm(
        embeddings, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.matmul(e, e.T)


def _pair_masks(labels: torch.Tensor):
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return same & ~eye, ~same      # anchor-positive, anchor-negative


def _mean_over(values: torch.Tensor, mask: torch.Tensor):
    count = torch.clamp(mask.sum(), min=1)
    return (values * mask).sum() / count, count


def batch_all_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                           margin: float = 0.2):
    """Mean hinge over all valid triplets."""
    cos = _cosine_matrix(embeddings)
    pos, neg = _pair_masks(labels)
    tri = torch.clamp(cos[:, None, :] - cos[:, :, None] + margin, min=0.0)
    return _mean_over(tri, pos[:, :, None] & neg[:, None, :])


def batch_hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                            margin: float = 0.2):
    """Hardest-negative hinge per (anchor, positive), averaged over the
    pairs whose hinge is positive."""
    cos = _cosine_matrix(embeddings)
    pos, neg = _pair_masks(labels)
    hardest_neg = torch.where(neg, cos, torch.full_like(cos, -torch.inf)).amax(dim=-1)
    losses = torch.clamp(hardest_neg[:, None] - cos + margin, min=0.0)
    return _mean_over(losses, pos & (losses > 0))


def semihard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                          margin: float = 0.2):
    """Mean hinge over semihard triplets (0 < loss < margin)."""
    cos = _cosine_matrix(embeddings)
    pos, neg = _pair_masks(labels)
    tri = cos[:, None, :] - cos[:, :, None] + margin
    valid = pos[:, :, None] & neg[:, None, :] & (tri > 0) & (tri < margin)
    return _mean_over(torch.clamp(tri, min=0.0), valid)


def contrastive_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                     margin: float = 0.5):
    """Pairwise contrastive loss over all batch pairs: positives pull the
    cosine toward 1, negatives push it below ``margin``."""
    cos = _cosine_matrix(embeddings)
    pos, neg = _pair_masks(labels)
    pos_loss = ((1.0 - cos) * pos).sum()
    neg_loss = (torch.clamp(cos - margin, min=0.0) * neg).sum()
    count = torch.clamp(pos.sum() + neg.sum(), min=1)
    return (pos_loss + neg_loss) / count, count


class OnlineTripletLoss:
    """``loss, n = criterion(embeddings, labels)`` with the mining
    ``strategy`` of ``train.triplet_strategy``."""

    def __init__(self, margin: float = 0.2,
                 strategy: Literal["all", "hardest", "semihard"] = "hardest", mesh=None):
        self.margin = margin
        self.strategy = strategy
        self.mesh = mesh

    def __call__(self, embeddings: torch.Tensor, labels: torch.Tensor):
        fn = {"all": batch_all_triplet_loss, "hardest": batch_hard_triplet_loss,
              "semihard": semihard_triplet_loss}[self.strategy]
        if self.mesh is not None:
            embeddings, labels = self.mesh.gather_rows(embeddings), self.mesh.gather_rows(labels)
        return fn(embeddings, labels, self.margin)
