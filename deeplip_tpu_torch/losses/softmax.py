"""Classification criteria for speaker-embedding training.

Counterpart of ``deeplip_tpu/losses/softmax.py``. So far only
:func:`softmax_cross_entropy`, which the video trainer uses; the margin
heads (``CrossEntropyHead``, ``LMCL``, ``AAMSoftmax``, ``ASoftmax``) come
with audio training.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy (torch ``F.cross_entropy``); ``reduction='none'``
    returns the per-example vector (for masked reductions)."""
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    per_example = logz - true_logit
    return per_example if reduction == "none" else per_example.mean()
