"""Plain PyTorch reference of the ``lipreading-resnet18-tcn`` configuration.

The Lipreading network of Martinez et al., "Lipreading using Temporal
Convolutional Networks" (ICASSP 2020, arXiv:2001.08702), with the trunk and
head that DeepLip's ``conf/video_config.json`` names, written from the
description and independent of the program:

- transform: one random crop offset per clip (uniform, from the caller's
  generator: ``dh``, then ``dw``, then the flips), a horizontal flip with
  probability 0.5, ``(x / 255 − 0.421) / 0.165``;
- frontend: Conv3d 64 × (5, 7, 7), stride (1, 2, 2), padding (2, 3, 3), no
  bias → batch norm → PReLU → max-pool (1, 3, 3) / (1, 2, 2) / (0, 1, 1);
- trunk: ResNet-18 without its stem, per frame: BasicBlocks of 64, 128,
  256, 512 channels (strides 1, 2, 2, 2), PReLU, 1 × 1 convolution + BN on a
  downsampling residual; the spatial mean;
- head: the multi-branch TCN, kernels 3, 5, 7 × 4 levels of 768 channels
  (dilation ``2^level``); each branch pads ``(k − 1)·d`` on both sides,
  convolves, normalises over the padded length, drops ``(k − 1)·d / 2``
  frames at each end and applies PReLU; dropout 0.2 after each of a level's
  two layers; a 1 × 1 convolution on the residual; PReLU; the mean over
  time; a linear layer to the classes;
- cross-entropy, and Adam (β 0.9 / 0.999, ε 1e-8) with coupled weight
  decay and the rate ``lr (1 + cos(π t / 5)) / 2`` at step ``t``.

Batch norms take batch statistics in float32. A BN + PReLU pair (the
frontend's and each block's first) is computed in float32 and rounded
once; the others normalise in the activation's type. The bf16 recipe runs
the frontend and the trunk in bf16 with bf16 casts of the weights, the
TCN, the head and the loss in float32; float32 products never use TF32.
``precision`` as in ``etdnn_vox12.py``: ``"f32"``, ``"bf16"``, and the
controls ``"tf32"`` and ``"fp8"`` (the bf16 convolutions' operands rounded
to float8 e4m3).

Dropout draws its masks from the card's default generator, so the caller
seeds it as the program's run was seeded and the masks match: the TCN runs
on ``(B, T, C)`` tensors in the program's order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.etdnn_vox12 import BatchNorm, arithmetic, fp8_round, widened

MEAN, STD = 0.421, 0.165


class PReLU(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def bn_prelu(bn: BatchNorm, act: PReLU, x: torch.Tensor) -> torch.Tensor:
    axes = tuple(range(x.ndim - 1))
    xf = widened(x)
    mean = xf.mean(axes)
    var = ((xf - mean) ** 2).mean(axes)
    y = (xf - mean) * torch.rsqrt(var + 1e-5) * bn.weight + bn.bias
    return torch.where(y >= 0, y, act.weight * y).to(x.dtype)


class Conv(nn.Module):
    """A bias-free convolution applied to a channels-last activation."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0, dims=2):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((c_out, c_in) + (k,) * dims if isinstance(k, int)
                                               else (c_out, c_in) + tuple(k)))
        self.stride, self.padding, self.dims = stride, padding, dims

    def forward(self, x, fp8: bool):
        w = self.weight.to(x.dtype)
        inp = x.movedim(-1, 1)
        if fp8:
            inp, w = fp8_round(inp), fp8_round(w)
        fn = F.conv2d if self.dims == 2 else F.conv3d
        return fn(inp, w, None, self.stride, self.padding).movedim(1, -1)


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, stride):
        super().__init__()
        self.conv1 = Conv(c_in, c_out, 3, stride, 1)
        self.bn1 = BatchNorm(c_out)
        self.relu1 = PReLU(c_out)
        self.conv2 = Conv(c_out, c_out, 3, 1, 1)
        self.bn2 = BatchNorm(c_out)
        self.relu2 = PReLU(c_out)
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(Conv(c_in, c_out, 1, stride), BatchNorm(c_out))
        else:
            self.downsample = None

    def forward(self, x, fp8):
        out = bn_prelu(self.bn1, self.relu1, self.conv1(x, fp8))
        out = self.bn2(self.conv2(out, fp8), True)
        res = x
        if self.downsample is not None:
            res = self.downsample[1](self.downsample[0](x, fp8), True)
        return self.relu2(out + res)


class Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        c_in = 64
        for stage, (c, s) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            setattr(self, f"layer{stage}", nn.Sequential(BasicBlock(c_in, c, s),
                                                         BasicBlock(c, c, 1)))
            c_in = c

    def forward(self, x, fp8):
        for stage in range(1, 5):
            for blk in getattr(self, f"layer{stage}"):
                x = blk(x, fp8)
        return widened(x).mean(dim=(1, 2))


class Branch(nn.Module):
    def __init__(self, c_in, c_out, k, dilation):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, dilation=dilation)
        self.batchnorm = BatchNorm(c_out)
        self.non_lin = PReLU(c_out)
        self.full = (k - 1) * dilation

    def forward(self, x):
        v = self.conv(F.pad(x, (0, 0, self.full, self.full)).transpose(1, 2)).transpose(1, 2)
        v = self.batchnorm(v, True)
        half = self.full // 2
        return self.non_lin(v[:, half:v.shape[1] - (self.full - half)])


class Level(nn.Module):
    def __init__(self, c_in, c_out, kernels, dilation, dropout):
        super().__init__()
        for i, k in enumerate(kernels):
            setattr(self, f"cbcr0_{i}", Branch(c_in, c_out // len(kernels), k, dilation))
        for i, k in enumerate(kernels):
            setattr(self, f"cbcr1_{i}", Branch(c_out, c_out // len(kernels), k, dilation))
        self.n, self.dropout = len(kernels), dropout
        self.downsample = nn.Conv1d(c_in, c_out, 1)
        self.relu_final = PReLU(c_out)

    def forward(self, x):
        out = torch.cat([getattr(self, f"cbcr0_{i}")(x) for i in range(self.n)], dim=-1)
        out = F.dropout(out, self.dropout, training=True)
        out = torch.cat([getattr(self, f"cbcr1_{i}")(out) for i in range(self.n)], dim=-1)
        out = F.dropout(out, self.dropout, training=True)
        res = self.downsample(x.transpose(1, 2)).transpose(1, 2)
        return self.relu_final(out + res)


class Lipreading(nn.Module):
    def __init__(self, model: dict, num_classes: int, hidden: int):
        super().__init__()
        kernels = list(model["tcn_kernel_size"])
        width = hidden * len(kernels) * int(model.get("tcn_width_mult", 1))
        self.frontend3D = nn.Sequential(Conv(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), dims=3),
                                        BatchNorm(64), PReLU(64))
        self.trunk = Trunk()
        self.tcn = nn.Module()
        self.tcn.mb_ms_tcn = nn.Module()
        self.tcn.mb_ms_tcn.network = nn.Sequential(*[
            Level(512 if i == 0 else width, width, kernels, 2 ** i, float(model["tcn_dropout"]))
            for i in range(int(model["tcn_num_layers"]))])
        self.tcn.tcn_output = nn.Linear(width, num_classes)

    def forward(self, x, dtype, fp8: bool):
        """``(B, T, H, W)`` float32 frames → ``(B, classes)`` logits."""
        b, t = x.shape[:2]
        x = x[..., None]
        if dtype is not None:
            x = x.to(dtype)
        conv, bn, act = self.frontend3D
        y = bn_prelu(bn, act, conv(x, fp8))
        y = F.max_pool3d(y.movedim(-1, 1), (1, 3, 3), (1, 2, 2), (0, 1, 1)).movedim(1, -1)
        feats = self.trunk(y.reshape((b * t,) + y.shape[2:]), fp8).reshape(b, t, -1)
        for level in self.tcn.mb_ms_tcn.network:
            feats = level(feats)
        return self.tcn.tcn_output(feats.mean(dim=1))


def build(config: dict) -> Lipreading:
    return Lipreading(config["model"], int(config["num_classes"]),
                      int(config["train"]["hidden_dim"]))


def transform(clips_u8: torch.Tensor, crop: int, gen: torch.Generator) -> torch.Tensor:
    """Random crop and flip with the draws taken from ``gen`` in the order
    ``dh``, ``dw``, flips; ``(B, T, crop, crop)`` float32."""
    b, _, h, w = clips_u8.shape
    dh = torch.randint(0, h - crop + 1, (b,), generator=gen)
    dw = torch.randint(0, w - crop + 1, (b,), generator=gen)
    flip = (torch.rand((b,), generator=gen) < 0.5).tolist()
    rows = []
    for i in range(b):
        c = clips_u8[i, :, int(dh[i]):int(dh[i]) + crop, int(dw[i]):int(dw[i]) + crop]
        rows.append(c.flip(-1) if flip[i] else c)
    return (torch.stack(rows).float() / 255.0 - MEAN) / STD


def train_steps(model: Lipreading, batches, config: dict, precision: str,
                gen: torch.Generator, dropout_seed: int, keep: int | None = None) -> dict:
    """Adam steps of the recipe over ``batches`` (``(uint8 clips, labels)``);
    readings as ``etdnn_vox12.train_steps``: losses, the first gradient as
    Adam took it (``g + wd·p`` of step 1) and each leaf's change. With
    ``keep``, each step takes only its first ``keep`` rows after the draws
    (the half-batch fault)."""
    train = config["train"]
    lr, wd = float(train["lr"]), float(train["weight_decay"])
    b1, b2, eps, t_max = 0.9, 0.999, 1e-8, int(train["t_max"])
    dtype = torch.bfloat16 if precision in ("bf16", "fp8") else None
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    torch.manual_seed(dropout_seed)
    with arithmetic(precision):
        for step, (clips, labels) in enumerate(batches):
            x = transform(clips, int(train["crop"]), gen)[:keep]
            x = x.to(model.tcn.tcn_output.weight.dtype)
            logits = model(x, dtype, precision == "fp8")
            loss = F.cross_entropy(logits, labels[:keep].long())
            grads = torch.autograd.grad(loss, list(params.values()))
            rate = lr * (1.0 + math.cos(math.pi * step / t_max)) / 2.0
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    g = g + wd * p
                    m[n].mul_(b1).add_((1 - b1) * g)
                    v[n].mul_(b2).add_((1 - b2) * g * g)
                    denom = (v[n] / (1 - b2 ** (step + 1))).sqrt() + eps
                    p.sub_(rate * (m[n] / (1 - b1 ** (step + 1))) / denom)
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: float((mi / (1 - b1)).double().norm()) for n, mi in m.items()}
    change = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
    return {"losses": losses, "first_grad": first, "change": change}
