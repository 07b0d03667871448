"""Optimizers with the reference's torch semantics and a rate that can live
on the device.

Counterpart of ``deeplip_tpu/train/state.py``, whose optax chains compose
what ``torch.optim`` does:

- ``torch_sgd`` chains ``add_decayed_weights`` → ``trace(momentum)`` →
  ``scale_by_learning_rate``: torch's SGD with coupled decay, ``g += wd·p``,
  ``buf = μ·buf + g``, ``p -= lr·buf`` (the trace is not premultiplied by
  the learning rate);
- ``torch_adam`` chains ``add_decayed_weights`` → ``scale_by_adam`` →
  ``scale_by_learning_rate``: torch's Adam with coupled L2 decay.

:class:`SGD` and :class:`Adam` compute those updates with torch's
``_foreach`` ops. Their ``step(lr)`` takes the rate as a 0-d tensor, so a
step captured in a CUDA graph reads the rate that the trainer writes before
each replay; without ``lr`` the group's ``lr`` (a float) is used, as in
``torch.optim``. On the card SGD computes ``torch.optim.SGD``'s numbers bit
for bit (its update rounds as torch's does), and Adam those of
``torch.optim.Adam(capturable=True)``, whose multi-tensor op order it
follows. Their state lives on the parameters' device, Adam's step
count too, and starts at zero (:meth:`~SGD.init_state`): SGD's first step
gives ``buf = μ·0 + g = g``, torch's ``buf = g``. A graph needs the state
to exist before capture, so a step that would create it during a capture
raises. ``torch.optim.SGD`` takes a tensor rate only by reading it on the
host, and its momentum buffers appear at the first step, which is why
neither torch optimizer is used here.

Finetuning freezes parameter groups (:func:`build_optimizer`'s
``trainable_mask``): a frozen group is left out of the optimizer, so it gets
no update, no decay and no momentum, which is what the JAX package's
``_zero_frozen`` gives.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch


def _scaled_update(params: list, updates: list, lr) -> None:
    """``p += u · (-lr)`` over the lists; ``lr`` a float or a 0-d tensor.
    Both forms round as ``torch.optim.SGD``'s ``add_(u, alpha=-lr)`` does
    (one fused multiply-add), so a tensor rate steps bit for bit like the
    float one."""
    if isinstance(lr, torch.Tensor):
        neg = -lr.to(params[0].dtype)
        torch._foreach_addcmul_(params, updates, [neg] * len(params))
    else:
        torch._foreach_add_(params, updates, alpha=-lr)


class _DeviceStateOptimizer(torch.optim.Optimizer):
    """State made up front as zeros on the parameters' device."""

    def _fresh_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def init_state(self) -> None:
        """Create every parameter's state (zeros) where it is missing."""
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p].update(self._fresh_state(p, group))

    def _group_state(self, group: dict):
        """``(params, grads, states)`` of the group's parameters that have a
        gradient."""
        params = [p for p in group["params"] if p.grad is not None]
        if any(not self.state[p] for p in params):
            if params[0].is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("optimizer state must exist before a CUDA graph "
                                   "capture: call init_state() first")
            self.init_state()
        return params, [p.grad for p in params], [self.state[p] for p in params]


class SGD(_DeviceStateOptimizer):
    """SGD with momentum (no dampening, no Nesterov) and torch's coupled
    weight decay."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    def _fresh_state(self, p, group):
        return {"momentum_buffer": torch.zeros_like(p)} if group["momentum"] else {}

    @torch.no_grad()
    def step(self, lr: torch.Tensor | None = None):
        for group in self.param_groups:
            params, grads, states = self._group_state(group)
            if not params:
                continue
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            if group["momentum"]:
                bufs = [s["momentum_buffer"] for s in states]
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, grads)
                grads = bufs
            _scaled_update(params, grads, group["lr"] if lr is None else lr)


class Adam(_DeviceStateOptimizer):
    """Adam with torch's coupled L2 decay, in the op order of torch's
    capturable multi-tensor Adam."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _fresh_state(self, p, group):
        return {"step": torch.zeros((), dtype=p.dtype, device=p.device),
                "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for p, s in self.state.items():
            if "step" in s:   # a count saved on the host moves to the parameter
                s["step"] = torch.as_tensor(s["step"]).to(p.device, p.dtype)

    @torch.no_grad()
    def step(self, lr: torch.Tensor | None = None):
        for group in self.param_groups:
            params, grads, states = self._group_state(group)
            if not params:
                continue
            rate = group["lr"] if lr is None else lr.to(params[0].dtype)
            beta1, beta2 = group["betas"]
            steps = [s["step"] for s in states]
            exp_avgs = [s["exp_avg"] for s in states]
            exp_avg_sqs = [s["exp_avg_sq"] for s in states]
            torch._foreach_add_(steps, 1)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            # -lr / (1 - beta1^t) and sqrt(1 - beta2^t), on the device
            step_size = torch._foreach_pow(beta1, steps)
            torch._foreach_sub_(step_size, 1)
            torch._foreach_div_(step_size, rate)
            torch._foreach_reciprocal_(step_size)
            bc2_sqrt = torch._foreach_pow(beta2, steps)
            torch._foreach_sub_(bc2_sqrt, 1)
            torch._foreach_neg_(bc2_sqrt)
            torch._foreach_sqrt_(bc2_sqrt)
            # p += m / ((sqrt(v) / sqrt(bc2) + eps) / step_size)
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(denom, step_size)
            torch._foreach_addcdiv_(params, exp_avgs, denom)


def torch_sgd(params, learning_rate: float, momentum: float = 0.9,
              weight_decay: float = 0.0) -> SGD:
    """SGD(momentum) with torch's coupled decay and update convention."""
    return SGD(params, lr=learning_rate, momentum=momentum, weight_decay=weight_decay)


def torch_adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> Adam:
    """Adam with torch's coupled L2 decay."""
    return Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


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
