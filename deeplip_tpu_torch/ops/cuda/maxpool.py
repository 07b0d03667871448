"""The Lipreading frontend's max-pool: wrappers of ``csrc/maxpool_kernel.cu``.

Window (1, 3, 3), stride (1, 2, 2), padding (0, 1, 1) with ``-inf`` over a
channels-last ``(N, T, H, W, C)`` activation (``deeplip_tpu/models/
lipreading.py:158-161``): the kernel that the JAX package's
``benchmarks/pool_mosaic_probe.py`` probed the TPU compiler for.

- :func:`maxpool_forward` returns ``(y, pos)``: ``y`` is ``(N, T, Ho, Wo,
  C)`` with ``Ho = (H - 1) // 2 + 1``, and ``pos`` (only ``with_pos``) one
  byte per element of ``y``, the row-major window position 0..8 of its
  maximum. The first maximum wins a tie and a NaN tap wins over everything,
  as in ``F.max_pool3d``.
- :func:`maxpool_backward` routes ``dy`` back through ``pos``: ``dx`` at a
  pixel is the sum, in a fixed order, of ``dy`` over the at most four
  windows whose maximum it is.
- :func:`maxpool_frontend` is the op the model calls. On a CUDA tensor it is
  an autograd function over the two kernels, in extraction, serving and
  training alike; it saves only ``pos`` for the backward.
- :func:`maxpool_positions_reference` and :func:`maxpool_backward_reference`
  are the plain versions of what the two kernels compute, ``pos`` and
  ``dx`` from ``(dy, pos)`` in the kernel's order of additions; the card's
  checks hold the kernels to them bit for bit. ``BWD_THREADS``,
  ``BWD_ROWS``, ``BWD_STAGE_BYTES`` and :func:`backward_lanes` are the
  backward kernel's tiling constants and its channels a thread.

On a CUDA tensor each wrapper launches its kernel on the current stream, or
raises: f32 or bf16, contiguous in ``(N, T, H, W, C)`` order, ``C`` a
multiple of 4. On a CPU tensor :func:`maxpool_frontend` is the plain
version, :func:`maxpool_frontend_reference`. ``build.LAUNCHES`` counts the
kernels' launches under ``maxpool_fwd`` and ``maxpool_bwd``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplip_tpu_torch.ops.cuda import build

_KERNEL_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward kernel's tiling (csrc/maxpool_kernel.cu): kBwdThreads, the
# most threads of a block; kBwdRows, the most window rows of a tile;
# kBwdStageBytes, the shared memory that stages a tile's windows
BWD_THREADS = 256
BWD_ROWS = 2
BWD_STAGE_BYTES = 48 * 1024 - 32
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {   # entry -> (launch-count keys, argtypes)
    "maxpool_forward": (("maxpool_fwd",), _ARGTYPES),
    "maxpool_backward": (("maxpool_bwd",), _ARGTYPES),
}
_entry = build.entries("maxpool_kernel", _SIGNATURES)


def pooled_size(n: int) -> int:
    """Output length of a 3-wide, stride-2, pad-1 window over ``n``."""
    return (n - 1) // 2 + 1


def backward_lanes(dtype: torch.dtype, c: int) -> int:
    """Channels one backward thread owns: 16 bytes, so 4 f32 or 8 bf16;
    bf16 takes 4 when ``c % 8 == 4``, where every other staged window
    starts 8 bytes off a 16-byte line."""
    return 8 if dtype == torch.bfloat16 and c % 8 == 0 else 4


def maxpool_frontend_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``F.max_pool3d`` on the ``(N, C, T, H, W)``
    view of a channels-last ``(N, T, H, W, C)`` activation."""
    return F.max_pool3d(x.movedim(-1, 1), (1, 3, 3), (1, 2, 2), (0, 1, 1)).movedim(1, -1)


def maxpool_positions_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel's ``pos``: for each output
    element the row-major window position (0..8) of its first maximum among
    the taps inside the frame, where a NaN tap takes over from whatever came
    before it (``F.max_pool3d``'s rule: greater than the maximum so far, or
    NaN)."""
    n, t, h, w, c = x.shape
    ho, wo = pooled_size(h), pooled_size(w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))   # tap (di, dj) of window (i, j) is xp[2i+di, 2j+dj]
    rows = torch.arange(ho, device=x.device) * 2 - 1   # each window's first pixel row
    cols = torch.arange(wo, device=x.device) * 2 - 1
    best = seen = at = None
    for k in range(9):
        di, dj = divmod(k, 3)
        r, cc = rows + di, cols + dj
        inside = (((r >= 0) & (r < h))[:, None] & ((cc >= 0) & (cc < w))[None, :])[:, :, None]
        v = xp[:, :, di:di + 2 * ho:2, dj:dj + 2 * wo:2]
        if best is None:
            best = v
            at = torch.zeros(v.shape, dtype=torch.uint8, device=x.device)
            seen = torch.zeros_like(inside)
        take = inside & (~seen | (v > best) | torch.isnan(v))
        best = torch.where(take, v, best)
        at = at.masked_fill(take, k)
        seen = seen | inside
    return at


def maxpool_backward_reference(dy: torch.Tensor, pos: torch.Tensor, in_shape) -> torch.Tensor:
    """Plain version of the backward kernel: ``dx`` of ``in_shape`` from
    ``dy`` and the forward's ``pos``. Pixel ``(2i+r, 2j+s)`` is ``0.f``
    plus the ``dy`` of windows ``(i, j)``, ``(i, j+1)``, ``(i+1, j)``,
    ``(i+1, j+1)`` (those that hold it) whose position is the pixel, added
    in that order in f32 and rounded once to ``dy``'s type."""
    n, t, h, w, c = in_shape
    ho, wo = pooled_size(h), pooled_size(w)
    g = F.pad(dy.float(), (0, 0, 0, 1, 0, 1))           # one window past each edge,
    p = F.pad(pos, (0, 0, 0, 1, 0, 1), value=255)       # whose position matches no tap
    dx = torch.empty((n, t, 2 * ho, 2 * wo, c), dtype=torch.float32, device=dy.device)
    for r in (0, 1):
        for s in (0, 1):
            acc = torch.zeros((n, t, ho, wo, c), dtype=torch.float32, device=dy.device)
            for oi in range(r + 1):
                for oj in range(s + 1):
                    tap = (r - 2 * oi + 1) * 3 + (s - 2 * oj + 1)
                    hit = p[:, :, oi:oi + ho, oj:oj + wo] == tap
                    # adding 0.0 for a miss is skipping it: a sum from 0.f
                    # is never -0.0
                    acc = acc + torch.where(hit, g[:, :, oi:oi + ho, oj:oj + wo], 0.0)
            dx[:, :, r::2, s::2] = acc
    return dx[:, :, :h, :w].to(dy.dtype)


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches on a cuda tensor, not {x.device}")
    if x.dtype not in _KERNEL_TYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 5 or not x.is_contiguous():
        raise ValueError(
            f"{what} takes a contiguous channels-last (N, T, H, W, C) activation, "
            f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.shape[-1] % 4 or x.shape[-1] < 4:
        raise ValueError(f"{what} takes C a multiple of 4, got C={x.shape[-1]}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} needs a 16-byte aligned activation")


def _launch(name: str, a: torch.Tensor, pos, out: torch.Tensor, in_shape) -> None:
    """Both C functions take (input, pos, output, is_bf16, NT, H, W, C, Ho,
    Wo, stream)."""
    n, t, h, w, c = in_shape
    with torch.cuda.device(a.device):
        build.launch(_entry(name), a.data_ptr(), pos, out.data_ptr(), _KERNEL_TYPES[a.dtype],
                     n * t, h, w, c, pooled_size(h), pooled_size(w),
                     torch.cuda.current_stream().cuda_stream)


def maxpool_forward(x: torch.Tensor, with_pos: bool = False):
    """The forward kernel: ``(y, pos)``; ``pos`` is ``None`` unless
    ``with_pos``."""
    _check_cuda(x, "maxpool_forward")
    n, t, h, w, c = x.shape
    out_shape = (n, t, pooled_size(h), pooled_size(w), c)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    pos = torch.empty(out_shape, dtype=torch.uint8, device=x.device) if with_pos else None
    if y.numel():
        _launch("maxpool_forward", x, pos.data_ptr() if with_pos else None, y, x.shape)
    return y, pos


def maxpool_backward(dy: torch.Tensor, pos: torch.Tensor, in_shape) -> torch.Tensor:
    """The backward kernel: ``dx`` of shape ``in_shape`` from ``dy`` and the
    forward's ``pos``."""
    _check_cuda(dy, "maxpool_backward")
    n, t, h, w, c = in_shape
    out_shape = (n, t, pooled_size(h), pooled_size(w), c)
    if tuple(dy.shape) != out_shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not the pool of {tuple(in_shape)}")
    if (pos.dtype != torch.uint8 or tuple(pos.shape) != out_shape
            or pos.device != dy.device or not pos.is_contiguous()):
        raise ValueError(f"pos must be the forward's contiguous uint8 {out_shape} tensor "
                         f"on {dy.device}")
    dx = torch.empty(tuple(in_shape), dtype=dy.dtype, device=dy.device)
    if dy.numel():
        _launch("maxpool_backward", dy, pos.data_ptr(), dx, in_shape)
    else:
        dx.zero_()
    return dx



class _MaxPoolFrontend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, pos = maxpool_forward(x, with_pos=ctx.needs_input_grad[0])
        ctx.in_shape = tuple(x.shape)
        ctx.save_for_backward(pos)
        return y

    @staticmethod
    def backward(ctx, dy):
        (pos,) = ctx.saved_tensors
        # the trunk hands back a channels-last gradient; any other layout
        # raises in the wrapper, as the forward's input does (no hidden copy)
        return maxpool_backward(dy, pos, ctx.in_shape)


def maxpool_frontend(x: torch.Tensor) -> torch.Tensor:
    """The frontend max-pool of a channels-last ``(N, T, H, W, C)``
    activation, differentiable. CUDA: the kernels, or an error; CPU: the
    plain version."""
    if x.device.type == "cpu":
        return maxpool_frontend_reference(x)
    return _MaxPoolFrontend.apply(x)
