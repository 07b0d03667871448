"""ResNet-18-style 2D trunk of the lipreading network, channels-last.

Counterpart of ``deeplip_tpu/models/resnet.py``: no stem (the 3D frontend of
:class:`deeplip_tpu_torch.models.lipreading.Lipreading` takes its place),
BasicBlocks with stride 1/2/2/2, per-channel PReLU or ReLU, a 1x1-conv
downsample (or the ceil-mode avg-pool variant), and a global average pool
to ``(N, 512)``. Activations are ``(N, H, W, C)`` as in the JAX package;
each convolution sees them through a permuted ``(N, C, H, W)`` view, which
is channels-last in memory, so cuDNN keeps them channels-last.

Each convolution casts its float32 weight to the activation's type per
call, so a bf16 input (the Lipreading's ``compute_dtype``) runs the trunk
in bf16 with BN statistics in >= f32; the global average pool promotes to
>= f32, as the JAX trunk's does.

In train mode each ``bn1`` + PReLU pair runs as one fused op,
:func:`deeplip_tpu_torch.ops.cuda.bn_prelu.bn_prelu_train` (the K3/K4
kernels on the card), followed by ``bn1``'s running update. Parameter names
follow the reference torch layout (``conv1``, ``bn1``, ``relu1``, ...,
``downsample.{0,1}``), so ``interop.from_jax.lipreading_state_dict`` loads
with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.core.mesh import batch_group, global_rows
from deeplip_tpu_torch.models.initializers import lecun_normal_
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.ops.cuda import bn_prelu as K


class PReLU(nn.Module):
    """Per-channel PReLU over the last axis (torch ``nn.PReLU(C)``
    semantics: ``where(x >= 0, x, α·x)``)."""

    def __init__(self, num_parameters: int, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def make_act(relu_type: str, channels: int) -> nn.Module:
    if relu_type == "relu":
        return nn.ReLU()
    if relu_type == "prelu":
        return PReLU(channels)
    raise ValueError(f"relu type {relu_type!r} not implemented")


def bn_act(bn: TorchBatchNorm, act: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``act(bn(x))`` on a ``(..., C)`` activation. In train mode a PReLU
    pair runs as the fused op (K3 forward, K4 backward); the batch
    statistics it returns then feed ``bn``'s running update. On the card
    ``x`` comes from a cuDNN convolution of a channels-last input, which is
    itself channels-last, so its ``(..., C)`` view is contiguous as the
    kernels require. Inside a mesh's ``batch_stats`` block the statistics
    and the running update are the global batch's."""
    if not (bn.training and isinstance(act, PReLU)):
        return act(bn(x))
    group = batch_group()
    y, mean, var = K.bn_prelu_train(x, bn.weight, bn.bias, act.weight, bn.eps, group)
    bn.update_running(mean, var, global_rows(x, group))
    return y


def conv_nhwc(conv: nn.Conv2d | nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """Apply a bias-free ``(N, C, ...)`` convolution (grouped or not) to a
    channels-last ``(N, ..., C)`` activation and return ``(N, ..., C)``;
    the weight is cast to the activation's type. On the CPU the input is
    copied to contiguous ``(N, C, ...)``: PyTorch's CPU backward of a
    channels-last 1x1 stride-2 convolution corrupts its heap once the input
    shape changes between calls (torch 2.13, the audio ResNet's crop
    lengths)."""
    fn = F.conv2d if isinstance(conv, nn.Conv2d) else F.conv3d
    x = x.movedim(-1, 1)
    if x.device.type == "cpu":
        x = x.contiguous()
    y = fn(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, conv.dilation,
           conv.groups)
    return y.movedim(1, -1)


class BasicBlock(nn.Module):
    """conv3x3-BN-act-conv3x3-BN + (optional downsample) residual, act."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 relu_type: str = "prelu", avg_pool_downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.avg_pool_downsample = avg_pool_downsample
        self.conv1 = lecun_normal_(nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False))
        self.bn1 = TorchBatchNorm(planes)
        self.relu1 = make_act(relu_type, planes)
        self.conv2 = lecun_normal_(nn.Conv2d(planes, planes, 3, 1, 1, bias=False))
        self.bn2 = TorchBatchNorm(planes)
        self.relu2 = make_act(relu_type, planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            # the avg-pool variant pools first and then convolves at stride 1
            conv_stride = 1 if avg_pool_downsample else stride
            self.downsample = nn.Sequential(
                lecun_normal_(nn.Conv2d(inplanes, planes, 1, conv_stride, bias=False)),
                TorchBatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = bn_act(self.bn1, self.relu1, conv_nhwc(self.conv1, x))
        out = self.bn2(conv_nhwc(self.conv2, out))
        residual = x
        if self.downsample is not None:
            if self.avg_pool_downsample:
                # torch AvgPool2d(ceil_mode=True): odd dims round up and the
                # edge windows average only in-bounds pixels
                residual = F.avg_pool2d(
                    residual.movedim(-1, 1), self.stride, self.stride,
                    ceil_mode=True, count_include_pad=False).movedim(1, -1)
            residual = self.downsample[1](conv_nhwc(self.downsample[0], residual))
        return self.relu2(out + residual)


class ResNetTrunk(nn.Module):
    """Stemless ResNet: ``(N, H, W, 64) -> (N, 512)``; ``avg_pool_downsample``
    gives every downsampling block the avg-pool residual."""

    planes = (64, 128, 256, 512)
    strides = (1, 2, 2, 2)

    def __init__(self, layers=(2, 2, 2, 2), relu_type: str = "prelu",
                 avg_pool_downsample: bool = False):
        super().__init__()
        inplanes = 64
        for stage, (p, s, n) in enumerate(zip(self.planes, self.strides, layers), start=1):
            blocks = []
            for i in range(n):
                blocks.append(BasicBlock(inplanes, p, s if i == 0 else 1, relu_type,
                                         avg_pool_downsample))
                inplanes = p
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        # AdaptiveAvgPool2d(1) in >= f32
        return x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(1, 2))
