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
- :class:`CompactBilinearPooling`: count sketches of both inputs
  (scatter-add by a random hash, times a random sign), their rFFTs
  multiplied, and the inverse rFFT at ``output_dim``. The sketch pairs are
  buffers drawn from a seeded generator; ``interop.from_jax.cbp_state_dict``
  carries the JAX module's across.

A head fed bf16 embeddings computes in the type the JAX modules' promotion
gives: LowFER's gated concat in bf16 (f32 behind a ``gate_proj``), the
Dense layers of LinearFusion in f32. The JAX CBP's FFT takes no bf16 input,
and neither does this one.
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
            e2 = self.gate_proj(_promoted(e2, self.gate_proj.weight))
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
        h = F.leaky_relu(self.bn1(self.fc1(_promoted(x, self.fc1.weight))), 0.2)
        return h if self.extract_feats else self.fc2(h)


class CompactBilinearPooling(nn.Module):
    """Count-sketch FFT bilinear pooling: ``(B, d1), (B, d2) -> (B, output_dim)``.

    ``h1, s1`` and ``h2, s2`` (hash index and sign of each input feature)
    are buffers drawn from ``torch.Generator().manual_seed(seed)``."""

    def __init__(self, input_dims: tuple[int, int] = (512, 512), output_dim: int = 512,
                 seed: int = 0):
        super().__init__()
        self.output_dim = output_dim
        gen = torch.Generator().manual_seed(seed)
        for i, d in enumerate(input_dims, start=1):
            self.register_buffer(f"h{i}", torch.randint(0, output_dim, (d,), generator=gen))
            sign = torch.randint(0, 2, (d,), generator=gen).to(torch.float32) * 2.0 - 1.0
            self.register_buffer(f"s{i}", sign)

    def sketch(self, x: torch.Tensor, h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Scatter-add of ``x * s`` by index ``h`` into ``output_dim`` bins."""
        out = x.new_zeros(x.shape[:-1] + (self.output_dim,))
        return out.index_add(x.ndim - 1, h, x * s.to(x.dtype))

    def forward(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        if torch.bfloat16 in (e1.dtype, e2.dtype):
            raise TypeError("CompactBilinearPooling takes float32 or float64 inputs: its "
                            "rFFT, as the JAX module's, refuses bfloat16")
        f1 = torch.fft.rfft(self.sketch(e1, self.h1, self.s1), dim=-1)
        f2 = torch.fft.rfft(self.sketch(e2, self.h2, self.s2), dim=-1)
        return torch.fft.irfft(f1 * f2, n=self.output_dim, dim=-1)


def _promoted(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` in the type flax's Dense computes a ``(x, weight)`` pair in."""
    return x.to(torch.promote_types(x.dtype, weight.dtype))
