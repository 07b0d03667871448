"""Batch normalization over the last (feature) axis with torch's running-stat
semantics.

Counterpart of ``deeplip_tpu/models/norm.py: TorchBatchNorm``. Parameters
and buffers are named as torch's ``BatchNorm1d`` names them (``weight``,
``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``), so the
reference state dicts load with ``strict=True``.

- train: ``y = (x - μ_b) * rsqrt(σ²_b + eps) * scale + bias`` with the biased
  batch variance over all non-feature axes, computed in >= f32: single-pass
  ``max(E[x²]−E[x]², 0)`` on >= 4-D inputs (the video trunk's activations,
  fed by bias-free convs), torch's two-pass form on 3-D and 2-D inputs (TCN
  and Dense outputs, whose producers carry biases);
- running update (torch ``momentum = 1 - self.momentum``):
  ``mean ← m·mean + (1-m)·μ_b`` and ``var ← m·var + (1-m)·σ²_b·n/(n-1)``,
  and ``num_batches_tracked`` counts up;
- eval: normalize with the running statistics, op order
  ``(x - mean) * rsqrt(var + eps) * scale + bias``.

Inside a mesh's ``batch_stats`` block (``core.mesh``) the train-mode
statistics are those of the global batch, as under the JAX package's
sharded ``jit`` (its sync-BN): each rank weights its own means by its share
of the rows, ``n_local / n``, and one differentiable all-reduce
(``torch.distributed.nn.functional.all_reduce``, whose backward sums the
gradients) adds them. On >= 4-D inputs E[x] and E[x²] go in one all-reduce;
on 3-D and 2-D inputs E[x] goes first and then E[(x−μ)²], the two-pass
rule. ``n`` is the global count, so every rank folds the same Bessel
factor into the same running buffers. The share is exactly 1 at world
size 1, so a group of one gives the statistics of no group bit for bit.
Every rank must bring the same number of rows (the trainers pad to the
world size).
"""

from __future__ import annotations

import torch
from torch import nn

from deeplip_tpu_torch.core.mesh import batch_group, global_rows, rank_share


class TorchBatchNorm(nn.Module):
    """BN on ``(..., C)`` activations (feature axis = -1)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # decay on the OLD statistics
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Fold one batch's statistics (biased ``var`` over ``n`` elements
        per channel) into the running ones."""
        m = self.momentum
        bessel = n / (n - 1) if n > 1 else 1.0
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var * bessel)
        self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            group = batch_group()
            if group is None:
                mean, var, n = self._batch_stats(x)
            else:
                mean, var, n = self._global_batch_stats(x, group)
            self.update_running(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)

    @staticmethod
    def _batch_stats(x: torch.Tensor):
        red = tuple(range(x.ndim - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(red)
        if x.ndim >= 4:
            var = torch.clamp((xf * xf).mean(red) - mean * mean, min=0.0)
        else:
            var = ((xf - mean) ** 2).mean(red)
        return mean, var, global_rows(x)

    @staticmethod
    def _global_batch_stats(x: torch.Tensor, group):
        from torch.distributed.nn.functional import all_reduce

        red = tuple(range(x.ndim - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        share = rank_share(group)
        if x.ndim >= 4:
            moments = all_reduce(torch.stack([xf.mean(red), (xf * xf).mean(red)]) * share,
                                 group=group)
            mean = moments[0]
            var = torch.clamp(moments[1] - mean * mean, min=0.0)
        else:
            mean = all_reduce(xf.mean(red) * share, group=group)
            var = all_reduce(((xf - mean) ** 2).mean(red) * share, group=group)
        return mean, var, global_rows(x, group)
