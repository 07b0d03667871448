"""Lipreading network: 3D-conv frontend → per-frame 2D trunk → TCN head.

Counterpart of ``deeplip_tpu/models/lipreading.py`` with the JAX package's
layouts at the public methods: clips are channels-last ``(B, T, H, W, 1)``
and frame features ``(B, T, backend_out)``: 512 for the ResNet trunk, 1024
for the ShuffleNetV2 one (2048 at ``width_mult: 2.0``).

- frontend3D: Conv3d C×(5,7,7), stride (1,2,2), pad (2,3,3), no bias, with
  C = 64 before the ResNet trunk and 24 before the ShuffleNetV2 one →
  BN → PReLU → max-pool (1,3,3)/(1,2,2)/pad (0,1,1) with ``-inf`` padding.
  The JAX package computes the same conv by a space-to-depth rewrite for
  the TPU; here it is a plain ``nn.Conv3d``. In train mode the BN + PReLU
  pair is the fused op (K3/K4 on the card). In f32 training the conv's
  weight gradient is ``csrc/conv3d_wgrad_kernel.cu`` on the card
  (:func:`frontend_conv`). The pool is
  :func:`deeplip_tpu_torch.ops.cuda.maxpool.maxpool_frontend` on the
  channels-last activation: the ``csrc/maxpool_kernel.cu`` kernels on the
  card, forward and backward, and their plain version
  (``maxpool_frontend_reference``, ``F.max_pool3d``) on the CPU.
- time folds into the batch for the trunk: ``(B, T, h, w, C)`` →
  ``(B·T, h, w, C)``, a view;
- trunk: ResNet-18 (``backbone_type: resnet``) or the ShuffleNetV2 trunk
  (``backbone_type: shufflenet``, stage widths by ``width_mult``);
- head: multi- or single-branch TCN over ``(B, T, C)`` (depthwise-separable
  with ``tcn_dwpw``), a length-masked mean consensus and a Linear to the
  speaker classes.

``compute_dtype`` (the Flax model's ``dtype`` field) sets the frame path's
compute type: with ``torch.bfloat16`` the frontend Conv3d, its BN and
PReLU and the max-pool run in bf16, each weight cast to bf16 per call and
every BN's statistics taken in >= f32. The ResNet trunk runs in bf16 too,
and its spatial mean promotes the frame features to f32. The ShuffleNetV2
trunk has no compute type, as in the JAX package, so it promotes its input
and runs in f32. Either way the TCN and the classifier run in f32 (the JAX
TCN has no ``dtype`` field). The default, None, computes in the input's
type.

Module names follow the reference layout (``frontend3D.{0,1,2}``,
``trunk.layer{s}.{i}`` or ``trunk.{0,1}.*``, ``tcn.mb_ms_tcn`` /
``tcn.tcn_trunk``, ``tcn.tcn_output``), so
``interop.from_jax.lipreading_state_dict`` loads with ``strict=True``.
Train or eval mode is the module's own (``.train()`` / ``.eval()``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from deeplip_tpu_torch.models.initializers import lecun_normal_
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import ResNetTrunk, bn_act, conv_nhwc, make_act
from deeplip_tpu_torch.models.shufflenetv2 import ShuffleNetV2Trunk
from deeplip_tpu_torch.models.tcn import MultibranchTemporalConvNet, TemporalConvNet
from deeplip_tpu_torch.ops.cuda import maxpool as P
from deeplip_tpu_torch.ops.cuda.conv3d_wgrad import conv3d_frontend
from deeplip_tpu_torch.ops.masked import length_mask


def frontend_conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """The frontend Conv3d of a channels-last clip. An f32 clip whose conv
    weight alone needs a gradient (f32 training) takes
    :func:`~deeplip_tpu_torch.ops.cuda.conv3d_wgrad.conv3d_frontend`, whose
    weight gradient is the hand-written kernel on the card; any other call
    (bf16, ``no_grad`` extraction, a frozen encoder, a clip that needs a
    gradient) takes ``conv_nhwc`` and cuDNN."""
    if (x.dtype == torch.float32 and torch.is_grad_enabled() and conv.weight.requires_grad
            and not x.requires_grad):
        return conv3d_frontend(x, conv.weight)
    return conv_nhwc(conv, x)


class TCNHead(nn.Module):
    """The reference's TCN wrapper: the temporal stack and the classifier."""

    def __init__(self, n_inputs: int, num_channels, kernel_sizes, dropout: float,
                 relu_type: str, num_classes: int, dwpw: bool = False):
        super().__init__()
        if len(kernel_sizes) == 1:
            self.tcn_trunk = TemporalConvNet(n_inputs, num_channels, kernel_sizes[0],
                                             dropout, relu_type, dwpw)
        else:
            self.mb_ms_tcn = MultibranchTemporalConvNet(n_inputs, num_channels,
                                                        kernel_sizes, dropout, relu_type, dwpw)
        self.tcn_output = lecun_normal_(nn.Linear(num_channels[-1], num_classes))

    def temporal(self, x: torch.Tensor) -> torch.Tensor:
        net = self.tcn_trunk if hasattr(self, "tcn_trunk") else self.mb_ms_tcn
        return net(x)


class Lipreading(nn.Module):
    def __init__(self, num_classes: int = 500, hidden_dim: int = 256,
                 backbone_type: str = "resnet", relu_type: str = "prelu",
                 width_mult: float = 1.0, tcn_kernel_sizes=(3, 5, 7),
                 tcn_num_layers: int = 4, tcn_dropout: float = 0.2,
                 tcn_dwpw: bool = False, tcn_width_mult: int = 1,
                 trunk_layers=(2, 2, 2, 2)):
        super().__init__()
        if backbone_type not in ("resnet", "shufflenet"):
            raise ValueError(f"backbone {backbone_type!r}")
        frontend_nout = 64 if backbone_type == "resnet" else 24
        self.frontend3D = nn.Sequential(
            lecun_normal_(nn.Conv3d(1, frontend_nout, (5, 7, 7), (1, 2, 2), (2, 3, 3),
                                    bias=False)),
            TorchBatchNorm(frontend_nout),
            make_act(relu_type, frontend_nout))
        if backbone_type == "resnet":
            self.trunk = ResNetTrunk(tuple(trunk_layers), relu_type)
        else:
            self.trunk = ShuffleNetV2Trunk(float(width_mult), frontend_nout)
        self.backend_out = 512 if backbone_type == "resnet" else self.trunk.backend_out
        tcn_ch = hidden_dim * len(tcn_kernel_sizes) * tcn_width_mult
        self.tcn = TCNHead(self.backend_out, (tcn_ch,) * tcn_num_layers,
                           tuple(tcn_kernel_sizes), tcn_dropout, relu_type, num_classes,
                           tcn_dwpw)

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any], num_classes: int,
                    **overrides) -> "Lipreading":
        """Build from the video JSON config (``conf/video_config.json``)."""
        kw = dict(
            num_classes=num_classes,
            backbone_type=cfg.get("backbone_type", "resnet"),
            relu_type=cfg.get("relu_type", "prelu"),
            width_mult=float(cfg.get("width_mult", 1.0)),
            tcn_kernel_sizes=tuple(cfg.get("tcn_kernel_size", (3, 5, 7))),
            tcn_num_layers=int(cfg.get("tcn_num_layers", 4)),
            tcn_dropout=float(cfg.get("tcn_dropout", 0.2)),
            tcn_dwpw=bool(cfg.get("tcn_dwpw", False)),
            tcn_width_mult=int(cfg.get("tcn_width_mult", 1)),
        )
        kw.update(overrides)
        return cls(**kw)

    def frame_features(self, x: torch.Tensor,
                       compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """``(B, T, H, W, 1) -> (B, T, backend_out)`` per-frame embeddings."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        b, t = x.shape[0], x.shape[1]
        conv, bn, act = self.frontend3D
        y = bn_act(bn, act, frontend_conv(conv, x))
        y = P.maxpool_frontend(y)
        feats = self.trunk(y.reshape((b * t,) + y.shape[2:]))
        return feats.reshape(b, t, -1)

    def classify(self, feats: torch.Tensor, lengths: torch.Tensor | None = None):
        """TCN + masked mean consensus + classifier over frame features."""
        out = self.tcn.temporal(feats)
        if lengths is None:
            pooled = out.mean(dim=1)
        else:
            mask = length_mask(lengths, out.shape[1], dtype=out.dtype)[..., None]
            pooled = (out * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
        return self.tcn.tcn_output(pooled)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None,
                compute_dtype: torch.dtype | None = None):
        return self.classify(self.frame_features(x, compute_dtype), lengths=lengths)
