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
kernels on the card), followed by ``bn1``'s running update. In eval mode,
on the card, with no gradient needed (a frozen encoder, extraction,
serving), each PReLU site is one pass of
:func:`deeplip_tpu_torch.ops.cuda.bn_prelu.bn_prelu_eval` with the running
statistics: ``bn1`` + PReLU, and ``bn2`` + the residual add (the
downsample's BN folded in) + PReLU, bit for bit the eager ops' result
(:func:`eval_kernel_takes`). Every other call (the CPU, f64, ReLU blocks,
an eval block whose output needs a gradient) runs the eager ops.
Parameter names follow the reference torch layout (``conv1``, ``bn1``, ``relu1``, ...,
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


_EVAL_KERNEL_TYPES = (torch.float32, torch.bfloat16)


def eval_kernel_takes(x: torch.Tensor, bns, act: nn.Module, params) -> bool:
    """Whether BN + PReLU sites over the activation ``x`` take the one-pass
    eval kernel: every BN of ``bns`` in eval mode, ``act`` a PReLU, an f32
    or bf16 ``x`` on the card, and no gradient needed (grad mode off, or
    neither ``x`` nor any of ``params`` requires one)."""
    if (any(bn.training for bn in bns) or not isinstance(act, PReLU) or not x.is_cuda
            or x.dtype not in _EVAL_KERNEL_TYPES):
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params)))


def eval_bn(bn: TorchBatchNorm) -> K.EvalBN:
    return K.EvalBN(bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)


def bn_act(bn: TorchBatchNorm, act: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``act(bn(x))`` on a ``(..., C)`` activation. In train mode a PReLU
    pair runs as the fused op (K3 forward, K4 backward); the batch
    statistics it returns then feed ``bn``'s running update. In eval mode it
    is the eval kernel's plain form where :func:`eval_kernel_takes` says so.
    On the card ``x`` comes from a cuDNN convolution of a channels-last
    input, which is itself channels-last, so its ``(..., C)`` view is
    contiguous as the kernels require. Inside a mesh's ``batch_stats`` block
    the statistics and the running update are the global batch's."""
    if bn.training and isinstance(act, PReLU):
        group = batch_group()
        y, mean, var = K.bn_prelu_train(x, bn.weight, bn.bias, act.weight, bn.eps, group)
        bn.update_running(mean, var, global_rows(x, group))
        return y
    if eval_kernel_takes(x, (bn,), act, (*bn.parameters(), *act.parameters())):
        return K.bn_prelu_eval(x, eval_bn(bn), act.weight)
    return act(bn(x))


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
        residual_bn = None if self.downsample is None else self.downsample[1]
        bns = (self.bn2,) if residual_bn is None else (self.bn2, residual_bn)
        fused = eval_kernel_takes(x, bns, self.relu2, self.parameters())
        out = conv_nhwc(self.conv2, bn_act(self.bn1, self.relu1, conv_nhwc(self.conv1, x)))
        if not fused:
            out = self.bn2(out)
        residual = x
        if self.downsample is not None:
            if self.avg_pool_downsample:
                # torch AvgPool2d(ceil_mode=True): odd dims round up and the
                # edge windows average only in-bounds pixels
                residual = F.avg_pool2d(
                    residual.movedim(-1, 1), self.stride, self.stride,
                    ceil_mode=True, count_include_pad=False).movedim(1, -1)
            residual = conv_nhwc(self.downsample[0], residual)
        if fused:
            # bn2, the residual add (the downsample's BN folded in) and relu2
            return K.bn_prelu_eval(out, eval_bn(self.bn2), self.relu2.weight, residual,
                                   None if residual_bn is None else eval_bn(residual_bn))
        if residual_bn is not None:
            residual = residual_bn(residual)
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
