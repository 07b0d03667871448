"""Temporal Convolutional Network head (single- and multi-branch), time-major.

Counterpart of ``deeplip_tpu/models/tcn.py`` on ``(B, T, C)`` activations.

- The reference pads each Conv1d by ``(k-1)·d`` on both sides and chomps
  ``(k-1)·d`` symmetrically AFTER BatchNorm. For eval-mode BN that is a
  centred SAME convolution, so the eval path pads ``(k-1)·d/2`` per side.
  In train mode BN takes its batch statistics over the UNCHOMPED
  ``T+(k-1)·d`` positions, so the train path pads by ``(k-1)·d``, convolves
  VALID, normalises, chomps, and only then applies the activation.
- ``MultibranchTemporalBlock``: parallel branches (kernel sizes [3, 5, 7]),
  each ``features/num_k`` channels, concatenated; two such layers with
  dropout; a 1x1 downsample whenever ``n_inputs // num_k != features``
  (the reference's condition, kept for state-dict shape parity).
- ``TemporalBlock``: the two-conv residual block of the single-branch TCN.
- ``dwpw``: each dilated conv becomes :class:`DepthwiseSeparableConv`, a
  depthwise conv (``groups=C_in``, no bias) with its BN taking train-mode
  statistics over the unchomped ``T+(k-1)·d`` positions, the chomp and the
  activation, then a 1x1 pointwise conv (no bias) whose BN sees the chomped
  ``T`` positions, and the activation. It serves both TCN forms.

The TCN's BN inputs are 3-D, so they take ``TorchBatchNorm``'s two-pass
statistics and never the fused BN+PReLU kernel. Module names follow the
reference layout (``network.{i}.cbcr0_{j}.{conv,batchnorm,non_lin}``,
``network.{i}.{conv1,batchnorm1,relu1,...}``). The reference has no layout
for ``dwpw``; its units take the JAX package's names
(``cbcr0_{j}.{dw_conv,dw_bn,dw_act,pw_conv,pw_bn,pw_act}`` and
``conv{1,2}.{dw_conv,...}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.models.initializers import lecun_normal_
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import make_act


def conv_bn_act(conv: nn.Conv1d, bn: TorchBatchNorm, act: nn.Module,
                x: torch.Tensor) -> torch.Tensor:
    """The reference's pad → conv → BN → symmetric chomp → activation on a
    ``(B, T, C)`` activation (the centred SAME conv in eval mode)."""
    full = (conv.kernel_size[0] - 1) * conv.dilation[0]
    half = full // 2
    pad = full if bn.training else half
    v = conv(F.pad(x, (0, 0, pad, pad)).transpose(1, 2)).transpose(1, 2)
    v = bn(v)
    if bn.training:
        v = v[:, half:v.shape[1] - (full - half)]
    return act(v)


class ConvBatchRelu(nn.Module):
    def __init__(self, n_inputs: int, features: int, kernel_size: int,
                 dilation: int, relu_type: str = "prelu"):
        super().__init__()
        self.conv = lecun_normal_(nn.Conv1d(n_inputs, features, kernel_size, dilation=dilation))
        self.batchnorm = TorchBatchNorm(features)
        self.non_lin = make_act(relu_type, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_act(self.conv, self.batchnorm, self.non_lin, x)


class DepthwiseSeparableConv(nn.Module):
    """The ``dwpw`` unit: depthwise dilated conv + BN + chomp + activation,
    then pointwise conv + BN + activation."""

    def __init__(self, n_inputs: int, features: int, kernel_size: int,
                 dilation: int, relu_type: str = "prelu"):
        super().__init__()
        self.dw_conv = lecun_normal_(nn.Conv1d(n_inputs, n_inputs, kernel_size,
                                               dilation=dilation, groups=n_inputs,
                                               bias=False))
        self.dw_bn = TorchBatchNorm(n_inputs)
        self.dw_act = make_act(relu_type, n_inputs)
        self.pw_conv = lecun_normal_(nn.Conv1d(n_inputs, features, 1, bias=False))
        self.pw_bn = TorchBatchNorm(features)
        self.pw_act = make_act(relu_type, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_act(self.dw_conv, self.dw_bn, self.dw_act, x)
        return self.pw_act(self.pw_bn(self.pw_conv(x.transpose(1, 2)).transpose(1, 2)))


class MultibranchTemporalBlock(nn.Module):
    def __init__(self, n_inputs: int, features: int, kernel_sizes, dilation: int,
                 dropout: float = 0.2, relu_type: str = "prelu", dwpw: bool = False):
        super().__init__()
        num_k = len(kernel_sizes)
        if features % num_k:
            raise ValueError("features must divide evenly across branches")
        branch_f = features // num_k
        self.num_branches = num_k
        unit = DepthwiseSeparableConv if dwpw else ConvBatchRelu
        for i, k in enumerate(kernel_sizes):
            setattr(self, f"cbcr0_{i}", unit(n_inputs, branch_f, k, dilation, relu_type))
        for i, k in enumerate(kernel_sizes):
            setattr(self, f"cbcr1_{i}", unit(features, branch_f, k, dilation, relu_type))
        self.dropout0 = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.downsample = (lecun_normal_(nn.Conv1d(n_inputs, features, 1))
                           if n_inputs // num_k != features else None)
        self.relu_final = make_act(relu_type, features)

    def _branches(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"cbcr{layer}_{i}")(x)
                          for i in range(self.num_branches)], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dropout0(self._branches(0, x))
        out = self.dropout1(self._branches(1, out))
        res = x if self.downsample is None else (
            self.downsample(x.transpose(1, 2)).transpose(1, 2))
        return self.relu_final(out + res)


class TemporalBlock(nn.Module):
    def __init__(self, n_inputs: int, features: int, kernel_size: int, dilation: int,
                 dropout: float = 0.2, relu_type: str = "prelu", dwpw: bool = False):
        super().__init__()
        self.dwpw = dwpw
        if dwpw:
            self.conv1 = DepthwiseSeparableConv(n_inputs, features, kernel_size, dilation,
                                                relu_type)
            self.conv2 = DepthwiseSeparableConv(features, features, kernel_size, dilation,
                                                relu_type)
        else:
            self.conv1 = lecun_normal_(nn.Conv1d(n_inputs, features, kernel_size,
                                                 dilation=dilation))
            self.batchnorm1 = TorchBatchNorm(features)
            self.relu1 = make_act(relu_type, features)
            self.conv2 = lecun_normal_(nn.Conv1d(features, features, kernel_size,
                                                 dilation=dilation))
            self.batchnorm2 = TorchBatchNorm(features)
            self.relu2 = make_act(relu_type, features)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.downsample = (lecun_normal_(nn.Conv1d(n_inputs, features, 1))
                           if n_inputs != features else None)
        self.relu = make_act(relu_type, features)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv{i}")
        if self.dwpw:
            return conv(x)
        return conv_bn_act(conv, getattr(self, f"batchnorm{i}"), getattr(self, f"relu{i}"), x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dropout1(self._conv(1, x))
        out = self.dropout2(self._conv(2, out))
        res = x if self.downsample is None else (
            self.downsample(x.transpose(1, 2)).transpose(1, 2))
        return self.relu(out + res)


class TemporalConvNet(nn.Module):
    """Single-branch TCN stack; the dilation doubles per level."""

    def __init__(self, n_inputs: int, num_channels, kernel_size: int = 3,
                 dropout: float = 0.2, relu_type: str = "prelu", dwpw: bool = False):
        super().__init__()
        blocks = []
        for i, ch in enumerate(num_channels):
            blocks.append(TemporalBlock(n_inputs, ch, kernel_size, 2 ** i, dropout, relu_type,
                                        dwpw))
            n_inputs = ch
        self.network = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(x)


class MultibranchTemporalConvNet(nn.Module):
    """Multi-branch TCN stack; the dilation doubles per level."""

    def __init__(self, n_inputs: int, num_channels, kernel_sizes=(3, 5, 7),
                 dropout: float = 0.2, relu_type: str = "prelu", dwpw: bool = False):
        super().__init__()
        blocks = []
        for i, ch in enumerate(num_channels):
            blocks.append(MultibranchTemporalBlock(n_inputs, ch, tuple(kernel_sizes),
                                                   2 ** i, dropout, relu_type, dwpw))
            n_inputs = ch
        self.network = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(x)
