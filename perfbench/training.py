"""What the training drivers share: the readings a check takes off the
program's first steps, made during set-up on the object that the window
then drives.

- :func:`first_gradient`: per leaf, the norm of the gradient as the
  optimizer took it at step 1, worked out from its state after that step
  (SGD's momentum buffer; Adam's first moment over ``1 − β1``);
- :func:`change`: per leaf, the norm of its change since the weights the
  benchmark loaded, read before step 4 overwrites them.
"""

from __future__ import annotations

import torch

from perfbench import compare


def named_leaves(modules: dict) -> dict:
    """``{prefix + name: parameter}`` over ``{prefix: module}``."""
    return {f"{prefix}{n}": p for prefix, m in modules.items() for n, p in m.named_parameters()}


def first_gradient(optimizer, leaves: dict) -> dict:
    by_id = {id(p): n for n, p in leaves.items()}
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "momentum_buffer" in state:
                out[by_id[id(p)]] = state["momentum_buffer"]
            elif "exp_avg" in state:
                out[by_id[id(p)]] = state["exp_avg"] / (1.0 - group["betas"][0])
            else:   # the optimizer took no step: nothing reached it
                out[by_id[id(p)]] = torch.zeros_like(p)
    return compare.norms(out)


def change(leaves: dict, start: dict) -> dict:
    return compare.norms({n: p.detach() - start[n] for n, p in leaves.items()})


def readings(losses: list, first: dict, moved: dict) -> dict:
    return {"losses": torch.stack([l.detach().double() for l in losses]).cpu().tolist(),
            "first_grad": first, "change": moved}
