"""Audio-visual fusion heads.

Counterpart of ``deeplip_tpu/models/fusion.py``:

- :class:`LowFER`: a low-rank bilinear (MFB) branch ``(e1 U) ⊙ (e2 V)``
  pooled over ``k`` and L2-normalised (:meth:`LowFER.mfb`), and the gated
  concat the head returns, ``[e1, σ(e2), σ(e2) ⊙ e1]`` of width ``3·d1``.
  The reference computes the MFB vector and then overwrites it, so ``U`` and
  ``V`` are parameters that never reach the output; they stay in the state
  dict (``U``, ``V``: the reference checkpoint layout). For unequal input
  dims a ``gate_proj`` Linear maps ``e2`` onto ``d1`` first.
- :class:`LinearFusion`: FC → BN → LeakyReLU(0.2) → FC over the concatenated
  pair; ``extract_feats`` returns the hidden layer.

``CompactBilinearPooling`` comes with fusion training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deeplip_tpu_torch.models.norm import TorchBatchNorm


class LowFER(nn.Module):
    def __init__(self, input_dims: tuple[int, int] = (512, 512), k: int = 30,
                 output_dim: int = 512):
        super().__init__()
        self.input_dims = tuple(input_dims)
        self.k = k
        self.output_dim = output_dim
        d1, d2 = self.input_dims
        self.U = nn.Parameter(torch.empty(d1, k * output_dim).uniform_(-1.0, 1.0))
        self.V = nn.Parameter(torch.empty(d2, k * output_dim).uniform_(-1.0, 1.0))
        if d1 != d2:
            self.gate_proj = nn.Linear(d2, d1)

    def mfb(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        """The low-rank bilinear branch: ``(B, o)``, L2-normalised."""
        x = (e1 @ self.U) * (e2 @ self.V)
        # (B, k*o) -> (B, o, k), the row-major split of torch's .view(-1, o, k)
        x = x.reshape(-1, self.output_dim, self.k).mean(-1)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)

    def forward(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        if self.input_dims[0] != self.input_dims[1]:
            e2 = self.gate_proj(e2)
        gate = torch.sigmoid(e2)
        return torch.cat([e1, gate, gate * e1], dim=-1)


class LinearFusion(nn.Module):
    """FC(in_dim → hidden) + BN + LeakyReLU + FC over ``[e1, e2]``;
    ``extract_feats`` taps the hidden layer."""

    def __init__(self, in_dim: int, hidden_size: int = 512, extract_feats: bool = False):
        super().__init__()
        self.extract_feats = extract_feats
        self.fc1 = nn.Linear(in_dim, hidden_size)
        self.bn1 = TorchBatchNorm(hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.bn1(self.fc1(x)), 0.2)
        return h if self.extract_feats else self.fc2(h)
