"""Batch normalization over the last (feature) axis, eval mode.

Counterpart of ``deeplip_tpu/models/norm.py: TorchBatchNorm`` in eval: the
running statistics normalise with the exact op order
``(x - mean) * rsqrt(var + eps) * scale + bias``. Parameters and buffers are
named as torch's ``BatchNorm1d`` names them (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so the
reference state dicts load with ``strict=True``.

Train-mode statistics (two-pass on 3-D inputs, single-pass on >= 4-D ones,
Bessel-corrected running variance) come with the training slice; a module in
train mode raises until then.
"""

from __future__ import annotations

import torch
from torch import nn


class TorchBatchNorm(nn.Module):
    """Eval-mode BN on ``(..., C)`` activations (feature axis = -1)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode batch statistics are not ported yet; call .eval()")
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x - self.running_mean) * inv
        return y * self.weight + self.bias
