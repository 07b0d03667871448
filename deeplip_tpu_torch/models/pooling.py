"""Temporal pooling for speaker embedding networks, on ``(B, T, C)``.

Counterpart of ``deeplip_tpu/models/pooling.py``. Every pooling takes an
optional ``lengths`` vector, so padded shape-bucketed batches reduce exactly
like unpadded ones.

The attentive poolings keep the JAX package's parameter names and shapes
(``W``, ``b``, ``v``, ``k``), cast to the input's type per call:

- ``AttentiveStatPooling``: scores ``relu(x Wᵀ + b) v + k`` softmaxed over
  time, then the attention-weighted mean and ``sqrt(max(E[x²] − E[x]², 0))``
  (no epsilon, as the JAX package has it);
- ``MonoHeadAttention``: the reference's quirk of scoring the *pre-ReLU*
  hidden map, and the weighted mean alone ``(B, C)``;
- ``MultiHeadAttentivePooling``: ``num_heads`` heads, each attending over
  its own channel slice, their weighted means and stds concatenated.
"""

from __future__ import annotations

import math

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


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Softmax over ``dim`` with masked positions at exactly 0."""
    if mask is not None:
        scores = torch.where(mask > 0, scores, float("-inf"))
    scores = scores - scores.amax(dim=dim, keepdim=True)
    e = torch.exp(scores)
    if mask is not None:
        e = e * (mask > 0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-30)


def _xavier_normal(*shape: int) -> nn.Parameter:
    """Flax's ``xavier_normal`` (fans over the last two axes, the leading
    ones a receptive field)."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return nn.Parameter(torch.randn(shape) * math.sqrt(2.0 / (fan_in + fan_out)))


class AttentiveStatPooling(nn.Module):
    """Attentive statistics pooling ``(B, T, C) -> (B, 2C)``."""

    def __init__(self, channels: int, hidden_size: int = 64):
        super().__init__()
        self.W = _xavier_normal(hidden_size, channels)
        self.b = _xavier_normal(1, hidden_size)
        self.v = _xavier_normal(hidden_size, 1)
        self.k = _xavier_normal(1, 1)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        w, b, v, k = (p.to(x.dtype) for p in (self.W, self.b, self.v, self.k))
        hidden = torch.einsum("btc,hc->bth", x, w) + b
        alpha = _masked_softmax(torch.relu(hidden) @ v + k, _time_mask(x, lengths), dim=1)
        mean = (alpha * x).sum(dim=1)
        sq = (alpha * x * x).sum(dim=1)
        return torch.cat([mean, torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))], dim=-1)


class MonoHeadAttention(nn.Module):
    """Single-head attention mean pooling ``(B, T, C) -> (B, C)``, scoring
    the pre-ReLU hidden projection as the reference does."""

    def __init__(self, channels: int, hidden_size: int = 64):
        super().__init__()
        self.W = _xavier_normal(hidden_size, channels)
        self.b = _xavier_normal(hidden_size, 1)
        self.v = _xavier_normal(1, hidden_size)
        self.k = _xavier_normal(1, 1)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        w, b, v, k = (p.to(x.dtype) for p in (self.W, self.b, self.v, self.k))
        hidden = torch.einsum("hc,btc->bht", w, x) + b               # (B, H, T)
        scores = (torch.einsum("oh,bht->bot", v, hidden) + k).transpose(1, 2)
        alpha = _masked_softmax(scores, _time_mask(x, lengths), dim=1)
        return (alpha * x).sum(dim=1)


class MultiHeadAttentivePooling(nn.Module):
    """Multi-head attentive statistics pooling ``(B, T, C) -> (B, 2C)``."""

    def __init__(self, channels: int, hidden_size: int = 64, num_heads: int = 4):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        d = channels // num_heads
        self.W = _xavier_normal(num_heads, hidden_size, d)
        self.b = nn.Parameter(torch.zeros(num_heads, hidden_size))
        self.v = _xavier_normal(num_heads, hidden_size)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        b_, t, c = x.shape
        xh = x.reshape(b_, t, self.num_heads, c // self.num_heads)
        w, b, v = (p.to(x.dtype) for p in (self.W, self.b, self.v))
        hidden = torch.relu(torch.einsum("btnd,nhd->btnh", xh, w) + b)
        scores = torch.einsum("btnh,nh->btn", hidden, v)
        # the (B, T, 1) mask broadcasts over the head axis
        alpha = _masked_softmax(scores, _time_mask(x, lengths), dim=1)[..., None]
        mean = (alpha * xh).sum(dim=1)                                  # (B, N, D)
        sq = (alpha * xh * xh).sum(dim=1)
        std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))
        return torch.cat([mean.reshape(b_, c), std.reshape(b_, c)], dim=-1)


POOLED_WIDTH = {"statistic": 2, "average": 1, "attentive_statistic": 2,
                "mono_head_attention": 1, "multi_head_attention": 2}


def pooling_from_name(name: str, channels: int, attention_hidden_size: int = 64) -> nn.Module:
    """The pooling a config names, over ``channels``-wide activations."""
    if name == "statistic":
        return MeanStdPooling()
    if name == "average":
        return AveragePooling()
    if name == "attentive_statistic":
        return AttentiveStatPooling(channels, attention_hidden_size)
    if name == "mono_head_attention":
        return MonoHeadAttention(channels, attention_hidden_size)
    if name == "multi_head_attention":
        return MultiHeadAttentivePooling(channels, attention_hidden_size)
    raise NotImplementedError(f"pooling {name!r} not implemented")
