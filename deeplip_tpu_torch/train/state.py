"""Optimizer construction with the reference's torch semantics.

Counterpart of ``deeplip_tpu/train/state.py``, whose optax chains compose
what ``torch.optim`` does natively:

- ``torch_sgd`` chains ``add_decayed_weights`` → ``trace(momentum)`` →
  ``scale_by_learning_rate``: torch's SGD with coupled decay, ``g += wd·p``,
  ``buf = μ·buf + g``, ``p -= lr·buf`` (the trace is not premultiplied by
  the learning rate);
- ``torch_adam`` chains ``add_decayed_weights`` → ``scale_by_adam`` →
  ``scale_by_learning_rate``: torch's Adam with coupled L2 decay.

Here those are ``torch.optim.SGD`` and ``torch.optim.Adam`` themselves; the
trainers set each group's ``lr`` from the schedule before every step, as
optax's step count would. Finetuning freezes parameter groups
(:func:`build_optimizer`'s ``trainable_mask``): a frozen group is left out
of the optimizer, so it gets no update, no decay and no momentum, which is
what the JAX package's ``_zero_frozen`` gives.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch


def torch_sgd(params, learning_rate: float, momentum: float = 0.9,
              weight_decay: float = 0.0) -> torch.optim.SGD:
    """SGD(momentum) with torch's coupled decay and update convention."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay)


def torch_adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with torch's coupled L2 decay."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def build_optimizer(opt_type: str, params: Mapping[str, Iterable[torch.nn.Parameter]],
                    learning_rate: float, momentum: float = 0.9,
                    weight_decay: float = 0.0,
                    trainable_mask: Mapping[str, bool] | None = None) -> torch.optim.Optimizer:
    """The ``train.type`` optimizer (``sgd`` or ``adam``) over named
    parameter groups (e.g. ``{"model": ..., "criterion": ...}``); a group
    whose ``trainable_mask`` entry is False is left out (frozen)."""
    groups = []
    for name, group in params.items():
        group = list(group)
        if group and (trainable_mask is None or trainable_mask.get(name, True)):
            groups.append({"params": group, "name": name})
    if opt_type == "sgd":
        return torch_sgd(groups, learning_rate, momentum, weight_decay)
    if opt_type == "adam":
        return torch_adam(groups, learning_rate, weight_decay)
    raise NotImplementedError(f"optimizer {opt_type!r}")
