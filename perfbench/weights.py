"""Seeded weights for a model, made on the device in two large calls.

The benchmark makes the weights, not the program: :func:`seeded_state`
reads the names and shapes of a state dict (the plain reference's, which
names its tensors as the program does) and fills them from one normal and
one uniform draw of a ``torch.Generator`` on the device, so that the
program and the reference load the same values:

- a weight of two or more axes: normal with variance ``1 / fan_in``;
- a batch norm's weight (a 1-D ``weight`` beside a ``running_mean``):
  ``1 + 0.1 z``; its bias ``0.1 z``; running mean ``0.1 z``, running
  variance uniform in [0.5, 2], the batch count 0;
- any other 1-D ``weight`` (PReLU slopes): ``0.25 + 0.05 z``;
- any other bias: ``0.01 z``.
"""

from __future__ import annotations

import math

import torch


def _kind(name: str, names: set) -> str:
    prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if leaf == "num_batches_tracked":
        return "count"
    if leaf in ("running_mean", "running_var"):
        return leaf
    bn = f"{prefix}.running_mean" in names if prefix else "running_mean" in names
    if leaf == "weight" and bn:
        return "bn_weight"
    if leaf == "bias" and bn:
        return "bn_bias"
    return leaf


def seeded_state(shapes: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for ``shapes`` (``{name: (shape, dtype)}``), float32
    except the batch counts."""
    names = sorted(shapes)
    kinds = {n: _kind(n, set(names)) for n in names}
    sizes = {n: math.prod(shapes[n][0]) for n in names}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes.values()), generator=gen, device=device)
    u = torch.rand(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for n in names:
        shape, k = tuple(shapes[n][0]), kinds[n]
        zi, ui = z[at:at + sizes[n]].view(shape), u[at:at + sizes[n]].view(shape)
        at += sizes[n]
        if k == "count":
            out[n] = torch.zeros(shape, dtype=shapes[n][1], device=device)
        elif k == "running_var":
            out[n] = 0.5 + 1.5 * ui
        elif k in ("running_mean", "bn_bias"):
            out[n] = 0.1 * zi
        elif k == "bn_weight":
            out[n] = 1.0 + 0.1 * zi
        elif len(shape) >= 2:
            out[n] = zi * math.sqrt(1.0 / math.prod(shape[1:]))
        elif n.endswith("weight"):
            out[n] = 0.25 + 0.05 * zi
        else:
            out[n] = 0.01 * zi
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {n: (tuple(t.shape), t.dtype) for n, t in module.state_dict().items()}
