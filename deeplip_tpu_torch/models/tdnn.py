"""TDNN / E-TDNN x-vector speaker embedding network.

Counterpart of ``deeplip_tpu/models/tdnn.py``. Public functions take and
return time-major ``(B, T, C)`` activations, as the JAX package's do; each
block transposes to NCW only around its ``Conv1d``.

- A context spec becomes ``kernel_size = len(context)`` and
  ``dilation = (context[-1] - context[0]) // (len(context) - 1)``, with
  VALID padding.
- With ``lengths``, pooling reduces only over outputs whose receptive field
  is fully real, which reproduces unpadded per-utterance results exactly.
- The module layout is the reference torch layout (``tdnn.{i}.context_layer``,
  ``tdnn.{i}.bn``, ``fc1``, ``bn1``, ``fc2``, ``bn2``), so its state dicts,
  and those carried across by ``interop.from_jax``, load with
  ``strict=True``. An attentive pooling adds ``pooling.{W,b,v,k}`` in the
  JAX package's shapes; the reference's mono-head file layout adds leading
  axes, which ``interop.torch_import`` takes off and ``interop.torch_export``
  puts back.

``extract_embedding`` returns ``(xv, x_a)``: ``xv`` is the second FC output
(the margin-loss embedding) and ``x_a`` the first FC pre-activation (the
CrossEntropy embedding); ``forward`` additionally applies bn2 + activation.

``compute_dtype`` (the Flax model's ``dtype`` field) sets the conv blocks'
compute type: with ``torch.bfloat16`` they convolve bf16 activations with
bf16 casts of the float32 parameters, BN takes its statistics in >= f32
and normalises in bf16, and the activations are cast back to >= f32 before
pooling, so pooling and the FC head run in f32 (f64 runs stay f64). The
default, None, computes in the input's type.

On the card a block's conv bias, BN and LeakyReLU (``bn_first``) run as one
fused op on the conv's ``(B, C, T)`` output, the conv then running without
its bias, :mod:`deeplip_tpu_torch.ops.cuda.tdnn_bn_act` (T): its train
kernels in train mode, its eval kernel in eval mode when no gradient is
needed (extraction, a frozen encoder). The fused op rounds
where the eager ops round (statistics in f32, the normalisation op by op in
the activation's type), so the blocks compute what they computed before,
and hand on the same ``(B, T, C)`` view of ``(B, C, T)`` memory. Every
other call keeps the eager ops: the CPU, f64, ``bn_first: false``, a step under a
mesh's batch group (whose statistics need an all-reduce that T does not
take yet), and an eval block whose output needs a gradient.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.core.mesh import batch_group
from deeplip_tpu_torch.models.initializers import lecun_normal_
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.pooling import POOLED_WIDTH, pooling_from_name
from deeplip_tpu_torch.ops.cuda import tdnn_bn_act as T

_NEGATIVE_SLOPE = 0.2
_FUSED_TYPES = (torch.float32, torch.bfloat16)


def context_to_kernel(context: Sequence[int]) -> tuple[int, int]:
    """``context -> (kernel_size, dilation)``."""
    kernel_size = len(context)
    if kernel_size > 1:
        dilation = (context[-1] - context[0]) // (kernel_size - 1)
    else:
        dilation = 1
    return kernel_size, dilation


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=_NEGATIVE_SLOPE)


def bn_leaky_ncw(bn: TorchBatchNorm, y: torch.Tensor, conv_bias: torch.Tensor) -> torch.Tensor:
    """``leaky(bn(y + conv_bias))`` on a conv's ``(B, C, T)`` output without
    its bias, as T's fused op, returned as ``(B, C, T)``: in train mode the
    batch statistics it returns feed ``bn``'s running update; in eval mode it
    applies the running statistics."""
    if bn.training:
        out, mean, var = T.tdnn_bn_act_train(y, conv_bias, bn.weight, bn.bias, bn.eps,
                                             _NEGATIVE_SLOPE)
        bn.update_running(mean, var, y.numel() // y.shape[1])
        return out
    return T.tdnn_bn_act_eval(y, conv_bias, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                              bn.eps, _NEGATIVE_SLOPE)


class TDNNBlock(nn.Module):
    """Dilated VALID Conv1d -> BN -> LeakyReLU(0.2) (order per ``bn_first``)
    on ``(B, T, C)``."""

    def __init__(self, in_dim: int, out_dim: int, context: Sequence[int],
                 bn_first: bool = True):
        super().__init__()
        kernel_size, dilation = context_to_kernel(context)
        self.context_layer = lecun_normal_(nn.Conv1d(in_dim, out_dim, kernel_size,
                                                     dilation=dilation))
        self.bn = TorchBatchNorm(out_dim)
        self.bn_first = bn_first

    def fused(self, x: torch.Tensor) -> bool:
        """Whether the conv bias, BN and LeakyReLU of input ``x``'s block
        take T's fused op: an f32 or bf16 activation on the card,
        ``bn_first``, no batch group, and in eval mode no gradient needed."""
        if (not x.is_cuda or x.dtype not in _FUSED_TYPES or not self.bn_first
                or batch_group() is not None):
            return False
        return self.bn.training or not (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.context_layer
        fused = self.fused(x)
        # the parameters are cast to the input's (compute) dtype; T adds the bias
        y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype),
                     None if fused else conv.bias.to(x.dtype), dilation=conv.dilation)
        if fused:
            return bn_leaky_ncw(self.bn, y, conv.bias).transpose(1, 2)
        y = y.transpose(1, 2)
        if self.bn_first:
            return _act(self.bn(y))
        return self.bn(_act(y))


class SpeakerEmbNet(nn.Module):
    """Config-driven TDNN/E-TDNN x-vector network."""

    def __init__(
        self,
        contexts: Sequence[Sequence[int]],
        hidden_dims: Sequence[int],
        input_dim: int = 24,
        embedding_dim: int = 512,
        pooling: str = "statistic",
        attention_hidden_size: int = 64,
        bn_first: bool = True,
    ):
        super().__init__()
        self.contexts = tuple(tuple(c) for c in contexts)
        self.bn_first = bn_first
        dims = [input_dim, *hidden_dims]
        self.tdnn = nn.ModuleList(
            TDNNBlock(dims[i], dims[i + 1], ctx, bn_first)
            for i, ctx in enumerate(self.contexts))
        self.pooling = pooling_from_name(pooling, hidden_dims[-1], attention_hidden_size)
        self.fc1 = lecun_normal_(nn.Linear(hidden_dims[-1] * POOLED_WIDTH[pooling],
                                           embedding_dim))
        self.bn1 = TorchBatchNorm(embedding_dim)
        self.fc2 = lecun_normal_(nn.Linear(embedding_dim, embedding_dim))
        self.bn2 = TorchBatchNorm(embedding_dim)

    @classmethod
    def from_config(cls, model_opts: Mapping[str, Any],
                    input_dim: int | None = None) -> "SpeakerEmbNet":
        """Build from the nested model config (``{'arch': ..., '<arch>': {...}}``);
        ``input_dim`` overrides the config's (the feature dimension)."""
        opts = model_opts[model_opts["arch"]]
        n = int(opts.get("tdnn_layers", len(opts["context"])))
        return cls(
            contexts=opts["context"][:n],
            hidden_dims=list(opts["hidden_dim"][:n]),
            input_dim=int(input_dim if input_dim is not None
                          else opts.get("input_dim", 24)),
            embedding_dim=int(opts["embedding_dim"]),
            pooling=opts.get("pooling", "statistic"),
            attention_hidden_size=int(opts.get("attention_hidden_size", 64)),
            bn_first=bool(opts.get("bn_first", True)),
        )

    @property
    def receptive_field(self) -> int:
        """Frames consumed by the VALID conv stack: ``T_out = T - rf + 1``."""
        rf = 1
        for ctx in self.contexts:
            k, d = context_to_kernel(ctx)
            rf += (k - 1) * d
        return rf

    def valid_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return torch.clamp(lengths - (self.receptive_field - 1), min=1)

    def extract_embedding(self, x: torch.Tensor, lengths=None,
                          compute_dtype: torch.dtype | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, T, D) -> (xv, x_a)``: margin-loss / CrossEntropy taps."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        for blk in self.tdnn:
            x = blk(x)
        # statistics pooling and the FC head stay >= float32
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        pooled_lengths = None if lengths is None else self.valid_lengths(lengths)
        x = self.pooling(x, lengths=pooled_lengths)
        x_a = self.fc1(x)
        if self.bn_first:
            x = _act(self.bn1(x_a))
        else:
            x = self.bn1(_act(x_a))
        return self.fc2(x), x_a

    def forward(self, x: torch.Tensor, lengths=None,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        xv, _ = self.extract_embedding(x, lengths=lengths, compute_dtype=compute_dtype)
        if self.bn_first:
            return _act(self.bn2(xv))
        return self.bn2(_act(xv))
