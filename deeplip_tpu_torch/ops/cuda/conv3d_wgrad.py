"""The Lipreading frontend Conv3d's FP32 weight gradient: wrapper of
``csrc/conv3d_wgrad_kernel.cu``.

The frontend conv is ``Conv3d(1 -> C, (5, 7, 7), stride (1, 2, 2), pad (2,
3, 3), no bias)`` (``models/lipreading.py``), C = 64 before the ResNet trunk
and 24 before the ShuffleNetV2 one. Its weight gradient is

    dW[co, 0, kt, kh, kw] = sum over b, t, ho, wo of
        dY[b, t, ho, wo, co] * x[b, t+kt-2, 2ho+kh-3, 2wo+kw-3]

with the clip zero outside its frames and pixels.

- :func:`conv3d_wgrad` is the op, ``torch.ops.deeplip.conv3d_wgrad``: ``dW``
  ``(C, 1, 5, 7, 7)`` from a channels-last ``dY`` ``(B, T, Ho, Wo, C)`` and the
  clip ``x`` ``(B, T, H, W)``. On a CUDA tensor it launches the kernel on the
  current stream, or raises: f32, contiguous, 16-byte aligned, C 24 or 64.
  On a CPU tensor it is the plain version. Its FLOPs, for
  ``FlopCounterMode``, are what aten's ``convolution_backward`` counts for
  the weight alone.
- :func:`conv3d_wgrad_reference` is the plain version: the same product as
  one matrix product a temporal tap, ``dY`` against the clip's 7 x 7 patches
  (``F.unfold``), in the input's type.
- :func:`conv3d_frontend` is the differentiable conv that
  ``Lipreading.frame_features`` takes for an f32 clip when only the weight
  needs a gradient: its forward is ``F.conv3d``, its backward the op for
  ``dW`` and no ``dx``.

``conv3d_wgrad.launches`` counts the kernel's launches (one a call; each
launch is the kernel and its pass that adds the blocks' sums).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_backward_flop, register_flop_formula

from deeplip_tpu_torch.ops.cuda import build

KERNEL = (5, 7, 7)
STRIDE = (1, 2, 2)
PADDING = (2, 3, 3)
CHANNELS = (24, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.load("conv3d_wgrad_kernel"), name)
    fn.argtypes = {"conv3d_wgrad_plan": [_I] * 5 + [_P, _P],
                   "conv3d_wgrad": [_P] * 4 + [_I] * 7 + [_P]}[name]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _plan(device_index: int, b: int, t: int, h: int, w: int, c: int) -> tuple[int, int]:
    """``(blocks, rows)`` of a shape on a card: the grid, which is also the
    scratch's number of ``C x 245`` slabs, and the output rows a band."""
    blocks, rows = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = _fn("conv3d_wgrad_plan")(b, t, h, w, c, ctypes.byref(blocks), ctypes.byref(rows))
    if err != 0:
        raise RuntimeError(f"conv3d_wgrad_plan failed for (B, T, H, W, C) = "
                           f"{(b, t, h, w, c)}: cudaError_t {err}")
    return blocks.value, rows.value


def _out_size(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _check_shapes(dy: torch.Tensor, x: torch.Tensor) -> None:
    if x.ndim != 4 or dy.ndim != 5:
        raise ValueError(f"conv3d_wgrad takes dY (B, T, Ho, Wo, C) and x (B, T, H, W), got "
                         f"{tuple(dy.shape)} and {tuple(x.shape)}")
    b, t, h, w = x.shape
    want = (b, t, _out_size(h, 7, 2, 3), _out_size(w, 7, 2, 3))
    if tuple(dy.shape[:4]) != want:
        raise ValueError(f"dY {tuple(dy.shape)} is not the frontend conv's output of x "
                         f"{tuple(x.shape)}: want {want + (dy.shape[-1],)}")


def _check_cuda(dy: torch.Tensor, x: torch.Tensor) -> None:
    for a, what in ((dy, "dY"), (x, "x")):
        if a.device.type != "cuda" or a.device != dy.device:
            raise ValueError(f"conv3d_wgrad launches on cuda tensors of one card, got {what} "
                             f"on {a.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"conv3d_wgrad takes float32, got {what} {a.dtype}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"conv3d_wgrad takes a contiguous, 16-byte aligned {what}")
    if dy.shape[-1] not in CHANNELS:
        raise ValueError(f"conv3d_wgrad takes C in {CHANNELS}, got C={dy.shape[-1]}")


def conv3d_wgrad_reference(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: for each temporal tap ``kt``, ``dY`` as a ``(positions,
    C)`` matrix against the ``(positions, 49)`` 7 x 7 patches of the frames
    ``t + kt - 2`` (zero outside the clip), in the input's type."""
    _check_shapes(dy, x)
    b, t, h, w = x.shape
    c = dy.shape[-1]
    rows = dy.reshape(-1, c)
    frames = F.pad(x, (0, 0, 0, 0, 2, 2))   # (B, T + 4, H, W)
    taps = []
    for kt in range(KERNEL[0]):
        clip = frames[:, kt:kt + t].reshape(b * t, 1, h, w)
        patches = F.unfold(clip, KERNEL[1:], padding=PADDING[1:], stride=STRIDE[1:])
        taps.append(rows.t() @ patches.transpose(1, 2).reshape(-1, KERNEL[1] * KERNEL[2]))
    return torch.stack(taps, dim=1).reshape(c, 1, *KERNEL)


@torch.library.custom_op("deeplip::conv3d_wgrad", mutates_args=())
def conv3d_wgrad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dW`` ``(C, 1, 5, 7, 7)`` of the frontend conv from ``dY`` ``(B, T,
    Ho, Wo, C)`` and the clip ``x`` ``(B, T, H, W)``. CUDA: the kernel, or an
    error; CPU: the plain version."""
    if dy.device.type == "cpu" and x.device.type == "cpu":
        return conv3d_wgrad_reference(dy, x)
    _check_shapes(dy, x)
    _check_cuda(dy, x)
    b, t, h, w = x.shape
    c = dy.shape[-1]
    dw = torch.empty((c, 1, *KERNEL), dtype=torch.float32, device=dy.device)
    if dy.numel() == 0:
        return dw.zero_()
    blocks, rows = _plan(dy.device.index, b, t, h, w, c)
    partial = torch.empty((blocks, c * dw[0].numel()), dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _fn("conv3d_wgrad")(dy.data_ptr(), x.data_ptr(), partial.data_ptr(),
                                  dw.data_ptr(), b, t, h, w, c, blocks, rows,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_wgrad launch failed: cudaError_t {err}")
    conv3d_wgrad.launches += 1
    return dw


conv3d_wgrad.launches = 0


@register_flop_formula(torch.ops.deeplip.conv3d_wgrad)
def _conv3d_wgrad_flop(dy_shape, x_shape, *args, out_shape=None, **kwargs) -> int:
    """aten's count for ``convolution_backward`` with only the weight's
    gradient asked for, at the frontend conv's shapes."""
    b, t, ho, wo, c = dy_shape
    return conv_backward_flop((b, c, t, ho, wo), (b, 1, *x_shape[1:]), out_shape, None, STRIDE,
                              PADDING, (1, 1, 1), False, (0, 0, 0), 1, [False, True, False],
                              out_val=[None, out_shape, None])


class _FrontendConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x)
        return F.conv3d(x.movedim(-1, 1), weight, None, STRIDE, PADDING).movedim(1, -1)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return None, conv3d_wgrad(dy.contiguous(), x[..., 0].contiguous())


def conv3d_frontend(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The frontend conv of a channels-last clip ``(B, T, H, W, 1)`` →
    ``(B, T, Ho, Wo, C)``, as ``conv_nhwc`` computes it, differentiable in
    ``weight`` alone: the clip must not need a gradient."""
    if x.requires_grad:
        raise ValueError("conv3d_frontend gives no gradient for the clip")
    return _FrontendConv3d.apply(x, weight)
