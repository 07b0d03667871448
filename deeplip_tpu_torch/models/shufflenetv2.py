"""ShuffleNetV2 trunk of the lipreading network, channels-last.

Counterpart of ``deeplip_tpu/models/shufflenetv2.py``: the staged inverted
residual units, the final 1x1 conv and the global average pool, without the
stem (the 3D frontend of :class:`deeplip_tpu_torch.models.lipreading.Lipreading`
takes its place). Stage widths follow the width-multiplier table: 0.5 →
(48, 96, 192, 1024), 1.0 → (116, 232, 464, 1024), 1.5 → (176, 352, 704,
1024), 2.0 → (244, 488, 976, 2048), with stage repeats (4, 8, 4).

Activations are ``(N, H, W, C)``; every convolution runs through
:func:`deeplip_tpu_torch.models.resnet.conv_nhwc`, the depthwise ones as
``groups=C`` convolutions. A stride-1 unit splits the channels into their
first and second halves and transforms the second; a stride-2 unit runs two
branches on the whole input. Either concatenates along the channel axis and
shuffles with ``reshape(..., 2, C/2)`` and a swap of the last two axes,
which on the channel axis of a channels-last tensor is the reference's NCHW
shuffle. Every BN is followed by a ReLU or by nothing, never by a PReLU, so
no BN here is the fused BN+PReLU op; the JAX trunk runs no Pallas kernel
either.

The trunk has no compute type of its own: its input is promoted to >= f32,
as Flax promotes a bf16 activation meeting f32 parameters, so a bf16
Lipreading runs its frontend in bf16 and this trunk in f32.

Module names follow the reference ``Sequential(features, conv_last)``
layout: ``trunk.0.{u}.banch1.{0..4}`` (dw conv, BN, pw conv, BN, ReLU) and
``trunk.0.{u}.banch2.{0..7}`` (pw conv, BN, ReLU, dw conv, BN, pw conv, BN,
ReLU), then ``trunk.1.{0,1,2}`` (conv, BN, ReLU), so a reference state dict
loads with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import conv_nhwc

STAGE_CHANNELS = {
    0.5: (48, 96, 192, 1024),
    1.0: (116, 232, 464, 1024),
    1.5: (176, 352, 704, 1024),
    2.0: (244, 488, 976, 2048),
}
STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave channel groups: ``(..., C) -> (..., C)`` shuffled."""
    *lead, c = x.shape
    return x.reshape(*lead, groups, c // groups).transpose(-1, -2).reshape(*lead, c)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)


def _run(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A conv/BN/ReLU sequence on a channels-last activation."""
    for layer in seq:
        x = conv_nhwc(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
    return x


class InvertedResidual(nn.Module):
    """ShuffleNetV2 unit; ``stride=1`` splits channels, ``stride=2`` downsamples."""

    def __init__(self, inp: int, oup: int, stride: int):
        super().__init__()
        self.stride = stride
        half = oup // 2
        if stride == 1:
            self.banch2 = nn.Sequential(
                _conv(half, half, 1), TorchBatchNorm(half), nn.ReLU(),
                _conv(half, half, 3, 1, half), TorchBatchNorm(half),
                _conv(half, half, 1), TorchBatchNorm(half), nn.ReLU())
        else:
            self.banch1 = nn.Sequential(
                _conv(inp, inp, 3, stride, inp), TorchBatchNorm(inp),
                _conv(inp, half, 1), TorchBatchNorm(half), nn.ReLU())
            self.banch2 = nn.Sequential(
                _conv(inp, half, 1), TorchBatchNorm(half), nn.ReLU(),
                _conv(half, half, 3, stride, half), TorchBatchNorm(half),
                _conv(half, half, 1), TorchBatchNorm(half), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=-1)
            out = torch.cat([x1, _run(self.banch2, x2)], dim=-1)
        else:
            out = torch.cat([_run(self.banch1, x), _run(self.banch2, x)], dim=-1)
        return channel_shuffle(out, 2)


class ShuffleNetV2Trunk(nn.Sequential):
    """``(N, H, W, C_in) -> (N, backend_out)``: the staged units (``0``), the
    final 1x1 conv with BN and ReLU (``1``), and the spatial mean."""

    def __init__(self, width_mult: float = 1.0, in_channels: int = 24):
        if width_mult not in STAGE_CHANNELS:
            raise ValueError(f"width_mult {width_mult} not in {sorted(STAGE_CHANNELS)}")
        chans = STAGE_CHANNELS[width_mult]
        units, inp = [], in_channels
        for c, reps in zip(chans[:-1], STAGE_REPEATS):
            for i in range(reps):
                units.append(InvertedResidual(inp, c, 2 if i == 0 else 1))
                inp = c
        super().__init__(
            nn.Sequential(*units),
            nn.Sequential(_conv(inp, chans[-1], 1), TorchBatchNorm(chans[-1]), nn.ReLU()))
        self.backend_out = chans[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        for unit in self[0]:
            x = unit(x)
        return _run(self[1], x).mean(dim=(1, 2))
