"""The numbers that decide ``correct``, from the program's and the
reference's readings.

A training cell reads three numbers off its first three steps (see
``drivers/``): each step's loss, the first gradient as the optimizer got it
(per leaf, worked out from the optimizer's state after one step), and the
change of each leaf over the three steps. Norms are compared leaf by leaf:
the gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
first gradient in the reference is under a thousandth of the median leaf's
(a bias under a batch norm) move by round-off alone and are left out of the
change.

A scoring cell compares every score and every embedding of a sample of its
trial lists by the largest absolute gap.
"""

from __future__ import annotations

import torch

NOUGHT = 1e-3   # a leaf's first gradient under this share of the median leaf's


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf's ``|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))[:5]}")
    names = sorted(ref)
    r = torch.tensor([float(ref[n]) for n in names], dtype=torch.float64)
    p = torch.tensor([float(prog[n]) for n in names], dtype=torch.float64)
    gaps = (p - r).abs() / torch.maximum(r, r.median())
    if keep is not None:
        gaps = gaps[torch.tensor([n in keep for n in names])]
    return float(gaps.max())


def worst_leaves(prog: dict, ref: dict, keep=None, n: int = 3) -> list:
    """The ``n`` leaves with the largest gaps, ``[name, gap, ref norm]``."""
    names = sorted(n_ for n_ in ref if keep is None or n_ in keep)
    med = float(torch.tensor([float(ref[k]) for k in ref], dtype=torch.float64).median())
    rows = [[k, abs(float(prog[k]) - float(ref[k])) / max(float(ref[k]), med), float(ref[k])]
            for k in names]
    return sorted(rows, key=lambda r: -r[1])[:n]


def moving_leaves(first_grad: dict) -> set:
    """Leaves whose first gradient is not nought to rounding."""
    med = torch.tensor([float(v) for v in first_grad.values()], dtype=torch.float64).median()
    return {n for n, v in first_grad.items() if float(v) >= NOUGHT * float(med)}


def train_numbers(prog: dict, ref: dict) -> list[tuple[str, float]]:
    """``loss_gap`` (largest relative gap of the three steps' losses),
    ``first_loss_gap`` (the first step's alone), ``grad_gap`` and
    ``change_gap`` (worst leaves) from two readings, each ``{"losses": [3],
    "first_grad": {leaf: norm}, "change": {leaf: norm}}``. A cell compares
    those its ``limits`` name."""
    losses = [abs(float(a) - float(b)) / abs(float(b))
              for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    return [("loss_gap", max(losses)), ("first_loss_gap", losses[0]),
            ("grad_gap", leaf_gap(prog["first_grad"], ref["first_grad"])),
            ("change_gap", leaf_gap(prog["change"], ref["change"],
                                    moving_leaves(ref["first_grad"])))]


def norms(tensors: dict) -> dict:
    """``{name: float64 norm}`` of a dict of tensors, read in one transfer."""
    names = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].detach().double())
                        for n in names]).cpu()
    return dict(zip(names, vals.tolist()))


def max_abs_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.shape != ref.shape:
        raise ValueError(f"shapes differ: {tuple(prog.shape)} vs {tuple(ref.shape)}")
    return float((prog.double() - ref.double()).abs().max())
