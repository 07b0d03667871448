"""2D-CNN speaker embedding network (the audio ``resnet`` arch).

Counterpart of ``deeplip_tpu/models/audio_resnet.py``: a spectrogram ResNet
x-vector over ``(B, T, D)`` features, seen as a one-channel ``(B, T, D, 1)``
image with the feature axis as its width:

- stem: 3x3 conv (no bias) to ``stage_widths[0]`` channels, BN, ReLU;
- stages of :class:`deeplip_tpu_torch.models.resnet.BasicBlock` with
  ``relu_type="relu"``, stride 2 at the first block of every stage but the
  first (so time and frequency shrink by 4 across the default three);
- a masked global average over ``(T', D')`` in >= f32: with ``lengths``,
  ``scale = T / T'`` and each row averages its first
  ``max(ceil(len / scale), 1)`` output frames, the division in float32 as
  the JAX module computes it;
- ``fc1 → bn1 → LeakyReLU(0.2) → fc2`` (``extract_embedding``), and
  ``bn2 → LeakyReLU(0.2)`` after it in ``forward``.

The interface is :class:`deeplip_tpu_torch.models.tdnn.SpeakerEmbNet`'s:
``receptive_field`` (1: the convs are SAME-padded), ``valid_lengths``,
``extract_embedding → (xv, x_a)`` and ``compute_dtype`` for the conv trunk,
while the pool and the FC head stay >= f32.

The reference release has no such module and no checkpoint layout for it.
The state dict takes the JAX package's names: ``stem``, ``stem_bn``,
``stage{s}_block{i}.{conv1,bn1,conv2,bn2,downsample.{0,1}}``, ``fc1``,
``bn1``, ``fc2``, ``bn2`` (``interop.from_jax.audio_resnet_state_dict``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.models.initializers import lecun_normal_
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import BasicBlock, conv_nhwc
from deeplip_tpu_torch.ops.masked import length_mask


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class MaskedGlobalMean(nn.Module):
    """``(B, T', D', C) -> (B, C)``: the mean over each row's valid output
    frames and every frequency column, in >= f32."""

    def forward(self, h: torch.Tensor, lengths: torch.Tensor | None, t_in: int) -> torch.Tensor:
        h = h.to(torch.promote_types(h.dtype, torch.float32))
        if lengths is None:
            return h.mean(dim=(1, 2))
        t_out = h.shape[1]
        # a float32 tensor quotient: a CUDA division by a Python scalar would
        # multiply by its reciprocal and could round across an integer
        scale = torch.tensor(t_in / t_out, dtype=torch.float32, device=h.device)
        valid = torch.clamp(torch.ceil(lengths.to(torch.float32) / scale), min=1.0)
        mask = length_mask(valid.to(torch.int32), t_out, h.dtype)[:, :, None, None]
        return (h * mask).sum(dim=(1, 2)) / (valid.to(h.dtype)[:, None] * h.shape[2])


class AudioResNet(nn.Module):
    def __init__(self, stage_widths=(64, 128, 256), stage_blocks=(3, 3, 3),
                 embedding_dim: int = 256):
        super().__init__()
        self.stem = lecun_normal_(nn.Conv2d(1, stage_widths[0], 3, 1, 1, bias=False))
        self.stem_bn = TorchBatchNorm(stage_widths[0])
        self.block_names = []
        inplanes = stage_widths[0]
        for stage, (w, n) in enumerate(zip(stage_widths, stage_blocks)):
            for i in range(n):
                name = f"stage{stage}_block{i}"
                setattr(self, name, BasicBlock(inplanes, w, 2 if (i == 0 and stage > 0) else 1,
                                               relu_type="relu"))
                self.block_names.append(name)
                inplanes = w
        self.pooling = MaskedGlobalMean()
        self.fc1 = lecun_normal_(nn.Linear(inplanes, embedding_dim))
        self.bn1 = TorchBatchNorm(embedding_dim)
        self.fc2 = lecun_normal_(nn.Linear(embedding_dim, embedding_dim))
        self.bn2 = TorchBatchNorm(embedding_dim)

    @classmethod
    def from_config(cls, model_opts: Mapping[str, Any]) -> "AudioResNet":
        """Build from the nested model config's ``resnet`` section."""
        opts = model_opts["resnet"]
        return cls(stage_widths=tuple(opts.get("hidden_dim", (64, 128, 256))),
                   stage_blocks=tuple(opts.get("residual_block_layers", (3, 3, 3))),
                   embedding_dim=int(opts.get("embedding_dim", 256)))

    @property
    def receptive_field(self) -> int:
        return 1

    def valid_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return lengths

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def trunk(self, x: torch.Tensor, lengths=None,
              compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """``(B, T, D) -> (B, C)``: the conv stack and the masked mean."""
        t_in = x.shape[1]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        h = torch.relu(self.stem_bn(conv_nhwc(self.stem, x[..., None])))
        for blk in self.blocks():
            h = blk(h)
        return self.pooling(h, lengths, t_in)

    def extract_embedding(self, x: torch.Tensor, lengths=None,
                          compute_dtype: torch.dtype | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, T, D) -> (xv, x_a)``: margin-loss / CrossEntropy taps."""
        x_a = self.fc1(self.trunk(x, lengths, compute_dtype))
        return self.fc2(_act(self.bn1(x_a))), x_a

    def forward(self, x: torch.Tensor, lengths=None,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        xv, _ = self.extract_embedding(x, lengths=lengths, compute_dtype=compute_dtype)
        return _act(self.bn2(xv))
