"""Temporal pooling for speaker embedding networks, on ``(B, T, C)``.

Counterpart of ``deeplip_tpu/models/pooling.py``. Every pooling takes an
optional ``lengths`` vector, so padded shape-bucketed batches reduce exactly
like unpadded ones. The attentive poolings are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from deeplip_tpu_torch.ops.masked import length_mask


def _time_mask(x: torch.Tensor, lengths) -> torch.Tensor | None:
    """(B, T, 1) float mask, or None when the batch is unpadded."""
    if lengths is None:
        return None
    return length_mask(lengths, x.shape[1], dtype=x.dtype)[..., None]


class MeanStdPooling(nn.Module):
    """Statistics pooling ``(B, T, C) -> (B, 2C)``: mean ++ unbiased std.

    Single-pass variance ``(Σx² − n·mean²)/(n−1)`` clamped at 0, with
    ``+1e-12`` inside the sqrt, as the JAX package computes it.
    """

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        mask = _time_mask(x, lengths)
        if mask is None:
            n = x.shape[1]
            mean = x.mean(dim=1)
            s2 = (x * x).sum(dim=1)
            var = torch.clamp(s2 - n * mean * mean, min=0.0) / max(n - 1, 1)
        else:
            count = torch.clamp(mask.sum(dim=1), min=1.0)
            mean = (x * mask).sum(dim=1) / count
            s2 = ((x * x) * mask).sum(dim=1)
            var = torch.clamp(s2 - count * mean * mean, min=0.0) / torch.clamp(
                count - 1.0, min=1.0)
        return torch.cat([mean, torch.sqrt(var + 1e-12)], dim=-1)


class AveragePooling(nn.Module):
    """Plain temporal mean ``(B, T, C) -> (B, C)``."""

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        mask = _time_mask(x, lengths)
        if mask is None:
            return x.mean(dim=1)
        return (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
