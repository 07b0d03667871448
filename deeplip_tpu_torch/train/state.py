"""Optimizer construction with the reference's torch semantics.

Counterpart of ``deeplip_tpu/train/state.py``: the JAX package's
``torch_adam`` chains ``add_decayed_weights`` → ``scale_by_adam`` →
``scale_by_learning_rate``, which is torch's Adam with coupled L2 decay (the
decay is folded into the gradient before the moments). Here that is
``torch.optim.Adam`` itself; the caller sets each group's ``lr`` from the
schedule before every step, as optax's step count would.
"""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with torch's coupled L2 decay."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
