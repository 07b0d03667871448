"""Classification criteria for speaker-embedding training.

Counterpart of ``deeplip_tpu/losses/softmax.py``. Every criterion is an
``nn.Module`` whose ``forward(embeddings, labels, ...)`` returns ``(loss,
logits)``, the logits being the pre-margin scores the trainer's accuracy
reads:

- :class:`CrossEntropyHead`: a linear head (``fc.weight``, ``fc.bias``) and
  softmax cross-entropy;
- :class:`LMCL` (AM-Softmax): cosine logits against the L2-normalised class
  ``weights``, an additive margin on the target class, scale ``s``, plus
  ``1e-5 * ||W||_1``. The margin is a per-call argument (the trainer's
  margin schedule), a float or a 0-d tensor;
- :class:`AAMSoftmax` (ArcFace): ``cos(θ + m)`` on the target, the cosine
  clipped to ±(1 − 1e-7), the linear surrogate ``cos θ − m·sin m`` past
  ``cos(π − m)``;
- :class:`ASoftmax` (SphereFace): ``ψ(θ) = (−1)^k cos(mθ) − 2k`` with the
  λ blend; the sign is a parity select, not ``pow``.

The parameter names are the reference torch layouts that
``interop.from_jax.criterion_state_dict`` writes. Embeddings of another
type than the parameters are normalised in their own type and then
promoted, as flax promotes them (the fusion trainer hands f32 embeddings to
a criterion of any type). The cosine products run at the tensors' own
precision: callers on the card keep TF32 off
(``core.device.fp32_math``), as the JAX package asks for
``precision="highest"``.

Each criterion's ``class_logits(embeddings, target, ...)`` gives the
logits its cross-entropy reads (the margin applied where the boolean
``target`` mask is set) and the logits the accuracy reads; ``forward`` is
the cross-entropy over them, plus :meth:`LMCL.penalty`. The same method
serves :func:`sharded_softmax_loss`, the classifier split by rows over a
mesh's ``model`` axis (``core.mesh.param_sharding``): each rank scores its
own classes, and the logsumexp and the target logit cross the ranks in
all-reduces, as the JAX package's ``param_sharding`` has XLA insert them.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.models.initializers import lecun_normal_


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy (torch ``F.cross_entropy``); ``reduction='none'``
    returns the per-example vector (for masked reductions)."""
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    per_example = logz - true_logit
    return per_example if reduction == "none" else per_example.mean()


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def _promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def _target(labels: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, n)`` boolean mask of each row's class."""
    return F.one_hot(labels.long(), n) > 0


class _CosineHead(nn.Module):
    """Class ``weights`` of shape ``(num_classes, d)``, kaiming-normal as the
    JAX package draws them: Flax's ``variance_scaling(2.0, 'fan_in')`` reads
    the fan-in from the shape's first axis, the class count, which is
    torch's fan-out."""

    def __init__(self, num_classes: int, embedding_dim: int):
        super().__init__()
        self.num_classes = num_classes
        self.weights = nn.Parameter(torch.empty(num_classes, embedding_dim))
        nn.init.kaiming_normal_(self.weights, mode="fan_out")

    def cosines(self, embeddings: torch.Tensor) -> torch.Tensor:
        return _promoted_matmul(_unit(embeddings), _unit(self.weights).T)


class CrossEntropyHead(nn.Module):
    """Linear classifier head returning ``(loss, logits)``."""

    def __init__(self, num_classes: int, embedding_dim: int):
        super().__init__()
        self.num_classes = num_classes
        self.fc = lecun_normal_(nn.Linear(embedding_dim, num_classes))

    def class_logits(self, embeddings: torch.Tensor, target: torch.Tensor = None):
        logits = self.fc(embeddings.to(torch.promote_types(embeddings.dtype,
                                                           self.fc.weight.dtype)))
        return logits, logits

    def forward(self, embeddings: torch.Tensor, labels: torch.Tensor,
                reduction: str = "mean"):
        logits, _ = self.class_logits(embeddings)
        return softmax_cross_entropy(logits, labels, reduction), logits


class LMCL(_CosineHead):
    """Large-margin cosine loss (AM-Softmax); ``margin`` defaults to
    ``init_margin`` and may change per call."""

    def __init__(self, num_classes: int, embedding_dim: int, scale: float = 30.0,
                 init_margin: float = 0.2, l1_weight: float = 1e-5):
        super().__init__(num_classes, embedding_dim)
        self.scale = scale
        self.init_margin = init_margin
        self.l1_weight = l1_weight

    def class_logits(self, embeddings: torch.Tensor, target: torch.Tensor, margin=None):
        margin = self.init_margin if margin is None else margin
        logits = self.cosines(embeddings)
        margins = target.to(logits.dtype) * margin
        return self.scale * (logits - margins), logits

    def penalty(self) -> torch.Tensor:
        """``1e-5 * ||W||_1`` of the (local) class weights."""
        return self.l1_weight * self.weights.abs().sum()

    def forward(self, embeddings: torch.Tensor, labels: torch.Tensor, margin=None,
                reduction: str = "mean"):
        z, logits = self.class_logits(embeddings, _target(labels, self.num_classes), margin)
        loss = softmax_cross_entropy(z, labels, reduction)
        return loss + self.penalty(), logits


class AAMSoftmax(_CosineHead):
    """ArcFace: additive angular margin ``cos(θ + m)`` on the target class."""

    def __init__(self, num_classes: int, embedding_dim: int, scale: float = 30.0,
                 init_margin: float = 0.2):
        super().__init__(num_classes, embedding_dim)
        self.scale = scale
        self.init_margin = init_margin

    def class_logits(self, embeddings: torch.Tensor, target: torch.Tensor, margin=None):
        margin = self.init_margin if margin is None else margin
        # a margin tensor stays on the device (a train step captured in a
        # CUDA graph reads the value written before each replay)
        trig = (torch if isinstance(margin, torch.Tensor) else math)
        # strictly inside [-1, 1]: at +-1 sqrt(1 - cos^2) has an infinite
        # derivative, which would NaN the first aligned embedding's gradient
        cos = self.cosines(embeddings).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
        sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
        cos_m, sin_m = trig.cos(margin), trig.sin(margin)
        phi = cos * cos_m - sin * sin_m
        phi = torch.where(cos > trig.cos(math.pi - margin), phi, cos - margin * sin_m)
        return self.scale * torch.where(target, phi, cos), cos

    def forward(self, embeddings: torch.Tensor, labels: torch.Tensor, margin=None,
                reduction: str = "mean"):
        z, cos = self.class_logits(embeddings, _target(labels, self.num_classes), margin)
        return softmax_cross_entropy(z, labels, reduction), cos


class ASoftmax(_CosineHead):
    """SphereFace A-Softmax: multiplicative angular margin ``cos(mθ)``, with
    ``(λ cos θ + ψ(θ)) / (1 + λ)`` on the target; ``lam`` may change per
    call (annealing)."""

    def __init__(self, num_classes: int, embedding_dim: int, m: int = 4,
                 base_lambda: float = 5.0):
        super().__init__(num_classes, embedding_dim)
        self.m = m
        self.base_lambda = base_lambda

    def class_logits(self, embeddings: torch.Tensor, target: torch.Tensor, lam=None):
        lam = self.base_lambda if lam is None else lam
        norms = torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True).clamp(min=1e-12)
        cos = _promoted_matmul(embeddings / norms, _unit(self.weights).T).clamp(
            -1.0 + 1e-7, 1.0 - 1e-7)
        theta = torch.arccos(cos)
        k = torch.floor(self.m * theta / math.pi)
        sign = 1.0 - 2.0 * torch.remainder(k, 2.0)   # (-1)^k by parity
        psi = sign * torch.cos(self.m * theta) - 2.0 * k
        blended = (lam * cos + psi) / (1.0 + lam)
        return torch.where(target, blended, cos) * norms, cos * norms

    def forward(self, embeddings: torch.Tensor, labels: torch.Tensor, lam=None,
                reduction: str = "mean"):
        z, logits = self.class_logits(embeddings, _target(labels, self.num_classes), lam)
        return softmax_cross_entropy(z, labels, reduction), logits


def sharded_softmax_loss(criterion: nn.Module, embeddings: torch.Tensor,
                         labels: torch.Tensor, offset: int, group, *margin):
    """The criterion's per-row cross-entropy and accuracy with its classes
    split by rows over ``group``: this rank holds classes ``[offset, offset
    + rows)``. Returns ``(per_example, correct)``, both ``(B,)`` and equal on
    every rank of the group; the per-example losses carry gradients to this
    rank's classes and, through the all-reduces' backward (a sum over the
    group), to the embeddings. ``margin`` is the criterion's per-call
    argument, if any."""
    from torch.distributed.nn.functional import all_reduce

    weight = next(criterion.parameters())
    local = torch.arange(weight.shape[0], device=labels.device) + offset
    target = labels.long()[:, None] == local[None, :]
    z, report = criterion.class_logits(embeddings, target, *margin)
    top = z.detach().amax(dim=-1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    total = all_reduce(torch.exp(z - top[:, None]).sum(dim=-1), group=group)
    true_logit = all_reduce(torch.where(target, z, torch.zeros_like(z)).sum(dim=-1),
                            group=group)
    per_example = torch.log(total) + top - true_logit
    # the accuracy's argmax over every rank's classes, the first index on a tie
    best, arg = report.detach().max(dim=-1)
    top_report = best.clone()
    dist.all_reduce(top_report, op=dist.ReduceOp.MAX, group=group)
    first = torch.where(best == top_report, arg + offset, torch.full_like(arg, 2 ** 62))
    dist.all_reduce(first, op=dist.ReduceOp.MIN, group=group)
    return per_example, first == labels.long()


def build_criterion(name: str, num_classes: int, embedding_dim: int,
                    scale: float = 30.0, margin: float = 0.2) -> nn.Module:
    """Criterion by the config's ``train.loss`` name."""
    if name == "CrossEntropy":
        return CrossEntropyHead(num_classes, embedding_dim)
    if name == "LMCL":
        return LMCL(num_classes, embedding_dim, scale=scale, init_margin=margin)
    if name == "AAM-Softmax":
        return AAMSoftmax(num_classes, embedding_dim, scale=scale, init_margin=margin)
    if name == "A-Softmax":
        return ASoftmax(num_classes, embedding_dim)
    raise NotImplementedError(f"loss {name!r} not implemented")
