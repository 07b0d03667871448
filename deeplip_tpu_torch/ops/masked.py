"""Masks for ragged batches padded to a shape bucket.

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
