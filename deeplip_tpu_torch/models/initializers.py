"""Flax's default initialiser for the port's dense and convolution layers.

The JAX package builds its ``nn.Dense`` and ``nn.Conv`` layers with Flax's
defaults: the kernel drawn from ``lecun_normal`` (a normal truncated at two
standard deviations, of variance ``1 / fan_in``) and the bias at zero.
torch's ``nn.Linear`` and ``nn.ConvNd`` draw the weight from a uniform of a
third of that variance and the bias from a uniform as well. From torch's
draw the flagship E-TDNN's short-crop LMCL recipe (SGD at 0.01) does not
learn in 30 steps, where it does from Flax's; so every such layer of the
port starts from Flax's draw.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(layer: nn.Module) -> nn.Module:
    """Draw ``layer``'s weight (an ``nn.Linear`` or ``nn.ConvNd``) from Flax's
    ``lecun_normal`` and zero its bias; returns ``layer``. The fan-in is
    the weight's per-output size (input channels per group times the
    kernel's extent), as Flax counts it."""
    std = math.sqrt(1.0 / layer.weight[0].numel()) / _TRUNCATED_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
        if layer.bias is not None:
            layer.bias.zero_()
    return layer
