"""ECAPA-TDNN speaker embedding network (the audio ``ecapa`` arch).

Desplanques, Thienpondt and Demuynck, "ECAPA-TDNN: Emphasized Channel
Attention, Propagation and Aggregation in TDNN Based Speaker Verification",
Interspeech 2020 (arXiv:2005.07143), Fig. 2. The JAX package has no such
module. Over ``(B, T, D)`` features, computed on their ``(B, C, T)``
transpose; every Conv1d keeps its bias and pads ``dilation·(k−1)/2`` zeros
on each side, so ``T`` is kept. ``TDNN(i→o, k, d)`` is Conv1d → ReLU → BN
(a :class:`~deeplip_tpu_torch.models.norm.TorchBatchNorm` over channels):

- ``layer1``: TDNN(D→C, k 5);
- three SE-Res2Blocks, dilation 2, 3, 4, on an input ``u``: ``a =
  TDNN(C→C, k 1)(u)``; ``a`` split into ``scale`` groups of ``C/scale``
  channels, the first passed through, ``y_2 = K_2(a_2)`` and ``y_i =
  K_i(a_i + y_{i−1})`` with ``K_i = TDNN(k 3, dilation d)`` (Res2Net's
  chain); ``b = TDNN(C→C, k 1)(cat(y))``; the squeeze-excitation gate ``g =
  sigmoid(W2 relu(W1 mean_t(b) + c1) + c2)``; the output ``g ⊙ b + u``;
- multi-layer feature aggregation: ``H = relu(Conv1d(3C→M, k 1)(cat(out_1,
  out_2, out_3)))``, no BN;
- attentive statistics pooling with global context: ``μ_g``, ``σ_g`` of
  ``H`` over the valid frames; ``e = Conv1d(A→M)(tanh(TDNN(3M→A)([H; μ_g;
  σ_g])))``; ``α = softmax_t(e)`` per channel; ``[μ̃; σ̃]`` the weighted
  mean and std, each ``σ = sqrt(clamp(E[h²] − μ², 1e-12))``; then BN
  (``pool_bn``);
- the head: ``x_a = fc2(p)``, ``xv = bn2(x_a)``.

The paper gives neither the attention's non-linearity nor the padding:
tanh after the TDNN as SpeechBrain's ``ECAPA_TDNN`` has it, and zeros at the
edges where SpeechBrain reflects.

The interface is :class:`deeplip_tpu_torch.models.tdnn.SpeakerEmbNet`'s:
``receptive_field`` (1: every conv keeps ``T``), ``valid_lengths``,
``extract_embedding → (xv, x_a)`` and ``forward → xv`` (no further
activation). The head's Linear and BN carry the names of SpeakerEmbNet's
last two layers, ``fc2`` and ``bn2``, whose width the trainers read as the
embedding's; the state dict's names are those of the benchmark's plain
reference (``perfbench/reference/ecapa_tdnn_c1024.py``).

With ``lengths``, the frames at or past a row's length are zeroed before
each convolution that spans more than one frame (``layer1``'s input and
each ``K_i``'s), and the SE means and the pooling's statistics and softmax
take the valid frames alone (padded frames get weight exactly 0), so a
row of a padded eval batch embeds as it does alone. With ``lengths=None``
(training crops) no mask op runs.

``compute_dtype`` casts the trunk, ``layer1`` through the aggregation, with
the parameters cast per call; BN takes its statistics in >= f32. The
pooling and the head run in >= f32 (f64 stays f64).

Spans (:mod:`deeplip_tpu_torch.core.spans`): ``deeplip.ecapa.res2net`` over
each block's split, ``K_i`` chain and concatenation; ``deeplip.ecapa.se``
over each gate, its product and the residual add; ``deeplip.ecapa.pool``
over the aggregation, the pooling, its BN and the head.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.core.spans import span
from deeplip_tpu_torch.models.initializers import lecun_normal_
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.ops.masked import length_mask

_BLOCK_DILATIONS = (2, 3, 4)
_STD_FLOOR = 1e-12


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``(B, C, T)`` with its parameters in ``x``'s type."""
    return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=conv.padding, dilation=conv.dilation)


def _masked(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    return x if mask is None else x * mask


def _time_mean(x: torch.Tensor, mask: torch.Tensor | None, count) -> torch.Tensor:
    """``(B, C, T) -> (B, C, 1)``: the mean over each row's valid frames
    (``count``, >= f32: a bf16 count is not exact past 256)."""
    if mask is None:
        return x.mean(dim=-1, keepdim=True)
    return ((x * mask).sum(dim=-1, keepdim=True) / count).to(x.dtype)


def _std(sq: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(sq - mean * mean, min=_STD_FLOOR))


class TDNN(nn.Module):
    """Conv1d → ReLU → BN over channels, on ``(B, C, T)``."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = lecun_normal_(nn.Conv1d(in_dim, out_dim, kernel_size, dilation=dilation,
                                            padding=dilation * (kernel_size - 1) // 2))
        self.bn = TorchBatchNorm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the BN normalises the last axis: a (B, T, C) view of the (B, C, T) memory
        return self.bn(torch.relu(_conv(self.conv, x)).transpose(1, 2)).transpose(1, 2)


class Res2Net(nn.Module):
    """The hierarchical chain over ``scale`` channel groups, the first
    passed through."""

    def __init__(self, channels: int, scale: int, kernel_size: int, dilation: int):
        super().__init__()
        if channels % scale:
            raise ValueError(f"{channels} channels do not split into {scale} groups")
        self.scale = scale
        width = channels // scale
        self.convs = nn.ModuleList(TDNN(width, width, kernel_size, dilation)
                                   for _ in range(scale - 1))

    def forward(self, a: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        parts = a.chunk(self.scale, dim=1)
        out, y = [parts[0]], None
        for part, conv in zip(parts[1:], self.convs):
            y = conv(_masked(part if y is None else part + y, mask))
            out.append(y)
        return torch.cat(out, dim=1)


class SEGate(nn.Module):
    """``sigmoid(conv2(relu(conv1(mean_t(b)))))``, ``(B, C, 1)``."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv1 = lecun_normal_(nn.Conv1d(channels, se_channels, 1))
        self.conv2 = lecun_normal_(nn.Conv1d(se_channels, channels, 1))

    def forward(self, b: torch.Tensor, mask: torch.Tensor | None, count) -> torch.Tensor:
        s = _time_mean(b, mask, count)
        return torch.sigmoid(_conv(self.conv2, torch.relu(_conv(self.conv1, s))))


class SERes2Block(nn.Module):
    def __init__(self, channels: int, scale: int, se_channels: int, dilation: int):
        super().__init__()
        self.tdnn1 = TDNN(channels, channels)
        self.res2net = Res2Net(channels, scale, 3, dilation)
        self.tdnn2 = TDNN(channels, channels)
        self.se = SEGate(channels, se_channels)

    def forward(self, u: torch.Tensor, mask: torch.Tensor | None, count) -> torch.Tensor:
        a = self.tdnn1(u)
        with span("deeplip.ecapa.res2net", u.device):
            r = self.res2net(a, mask)
        b = self.tdnn2(r)
        with span("deeplip.ecapa.se", u.device):
            return self.se(b, mask, count) * b + u


class AttentivePooling(nn.Module):
    """Channel- and context-dependent attentive statistics pooling,
    ``(B, M, T) -> (B, 2M)``."""

    def __init__(self, channels: int, attention_channels: int):
        super().__init__()
        self.tdnn = TDNN(3 * channels, attention_channels)
        self.conv = lecun_normal_(nn.Conv1d(attention_channels, channels, 1))

    def forward(self, h: torch.Tensor, mask: torch.Tensor | None, count) -> torch.Tensor:
        t = h.shape[-1]
        mean = _time_mean(h, mask, count)
        std = _std(_time_mean(h * h, mask, count), mean)
        context = torch.cat([h, mean.expand(-1, -1, t), std.expand(-1, -1, t)], dim=1)
        scores = _conv(self.conv, torch.tanh(self.tdnn(context)))
        if mask is not None:
            scores = scores.masked_fill(mask == 0, float("-inf"))
        alpha = torch.softmax(scores, dim=-1)
        mu = (alpha * h).sum(dim=-1)
        return torch.cat([mu, _std((alpha * h * h).sum(dim=-1), mu)], dim=-1)


class ECAPATDNN(nn.Module):
    def __init__(self, input_dim: int = 80, channels: int = 1024, scale: int = 8,
                 se_channels: int = 128, attention_channels: int = 128,
                 mfa_channels: int = 1536, embedding_dim: int = 192):
        super().__init__()
        self.layer1 = TDNN(input_dim, channels, 5)
        self.blocks = nn.ModuleList(SERes2Block(channels, scale, se_channels, d)
                                    for d in _BLOCK_DILATIONS)
        self.mfa = lecun_normal_(nn.Conv1d(len(_BLOCK_DILATIONS) * channels, mfa_channels, 1))
        self.pooling = AttentivePooling(mfa_channels, attention_channels)
        self.pool_bn = TorchBatchNorm(2 * mfa_channels)
        self.fc2 = lecun_normal_(nn.Linear(2 * mfa_channels, embedding_dim))
        self.bn2 = TorchBatchNorm(embedding_dim)

    @classmethod
    def from_config(cls, model_opts: Mapping[str, Any], input_dim: int) -> "ECAPATDNN":
        """Build from the nested model config's ``ecapa`` section (the
        widths, by ``__init__``'s names) over ``input_dim`` features."""
        return cls(input_dim=int(input_dim),
                   **{k: int(v) for k, v in model_opts["ecapa"].items()})

    @property
    def receptive_field(self) -> int:
        return 1

    def valid_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return lengths

    def extract_embedding(self, x: torch.Tensor, lengths=None,
                          compute_dtype: torch.dtype | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, T, D) -> (xv, x_a)``: the BN'd embedding and the Linear's
        output before it."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        x = x.transpose(1, 2)
        mask = count = None
        if lengths is not None:
            mask = length_mask(lengths, x.shape[-1], x.dtype)[:, None, :]
            count = torch.clamp(lengths, min=1).to(
                torch.promote_types(x.dtype, torch.float32))[:, None, None]
        u = self.layer1(_masked(x, mask))
        outs = []
        for block in self.blocks:
            u = block(u, mask, count)
            outs.append(u)
        with span("deeplip.ecapa.pool", x.device):
            h = torch.relu(_conv(self.mfa, torch.cat(outs, dim=1)))
            # the pooling and the head stay >= float32
            h = h.to(torch.promote_types(h.dtype, torch.float32))
            if mask is not None:
                mask = mask.to(h.dtype)
            x_a = self.fc2(self.pool_bn(self.pooling(h, mask, count)))
            return self.bn2(x_a), x_a

    def forward(self, x: torch.Tensor, lengths=None,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        xv, _ = self.extract_embedding(x, lengths=lengths, compute_dtype=compute_dtype)
        return xv
