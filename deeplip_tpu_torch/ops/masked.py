"""Masks and masked reductions for ragged batches padded to a shape bucket.

Counterpart of ``deeplip_tpu/ops/masked.py``.

The embedder's convolutions are VALID, so outputs whose receptive field lies
entirely in real frames equal the unpadded computation; masked reductions
over the valid region reproduce per-utterance results exactly.
"""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(B,) -> (B, max_len)`` mask of 1.0 for t < length."""
    t = torch.arange(max_len, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Mean over ``axis`` counting only masked-in positions (``mask``
    broadcasts against ``x``, 1.0 = keep); an empty row gives 0."""
    total = (x * mask).sum(dim=axis)
    count = mask.sum(dim=axis)
    return total / torch.clamp(count, min=1.0)


def masked_std(x: torch.Tensor, mask: torch.Tensor, axis: int = -1, ddof: int = 1,
               eps: float = 0.0) -> torch.Tensor:
    """Standard deviation over masked positions; ``ddof=1`` (unbiased) as
    ``torch.std`` in the reference's statistics pooling."""
    count = mask.sum(dim=axis)
    mean = (x * mask).sum(dim=axis) / torch.clamp(count, min=1.0)
    sq = ((x - mean.unsqueeze(axis)) ** 2 * mask).sum(dim=axis)
    return torch.sqrt(sq / torch.clamp(count - ddof, min=1.0) + eps)


def masked_mean_std(x: torch.Tensor, mask: torch.Tensor, axis: int = -1,
                    ddof: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked mean and (unbiased) std along ``axis`` together."""
    count = torch.clamp(mask.sum(dim=axis), min=1.0)
    mean = (x * mask).sum(dim=axis) / count
    sq = ((x - mean.unsqueeze(axis)) ** 2 * mask).sum(dim=axis)
    return mean, torch.sqrt(sq / torch.clamp(count - ddof, min=1.0))
