"""Fused train-mode BatchNorm + PReLU: wrappers of ``csrc/bn_prelu_kernel.cu``.

The port of ``deeplip_tpu/ops/pallas/bn_prelu_kernel.py``: K3, the forward
(``_stats_kernel`` + ``_apply_kernel``), and K4, its backward
(``_bwd_stats_kernel`` + ``_bwd_apply_kernel``).

- :func:`bn_prelu_forward` (K3) takes a channels-last activation ``(..., C)``
  and returns ``(y, mean, var, inv)``: batch statistics over every leading
  axis (biased variance, single-pass ``max(E[x²]−E[x]², 0)``) and
  ``y = where(z >= 0, z, α·z)`` with ``z = ((x−μ)·inv)·scale + bias``.
- :func:`bn_prelu_backward` (K4) returns ``(dx, dscale, dbias, dalpha)``.
- :func:`bn_prelu_train` is the autograd op over the two: ``(y, mean,
  var)``; the ``mean``/``var`` outputs feed the caller's running update and
  carry no gradient, as in the JAX package's custom VJP.

On a CUDA tensor each wrapper launches the kernels on the current stream,
or raises: it takes f32 or bf16 activations that are contiguous in
``(..., C)`` order (the row-major ``(rows, C)`` view of a channels-last
tensor; no copy is made for the caller), ``C`` a multiple of 4 up to 1024,
and f32 parameters. On a CPU tensor it runs the plain versions,
:func:`bn_prelu_reference` and :func:`bn_prelu_backward_reference`, in the
input's type promoted to at least f32. Each reduction is a partial pass and
a finalize pass, so a call launches three kernels, counted in
``build.LAUNCHES`` under ``bn_prelu_fwd`` and ``bn_prelu_bwd``.

For bf16 activations the plain versions, like the kernels, compute in f32
and round ``y`` and ``dx`` to bf16 once.

``group`` (a ``torch.distributed`` process group, data-parallel training
with one process per card) makes the statistics those of the global batch,
as the JAX package's sharded step computes them. Each finalize is then two
passes, chunk totals to float64 and totals to statistics, with an
all-reduce of the float64 totals between them (NCCL on the card, gloo on
the CPU) and the global row count in the second pass: four launches per
call, two of them the split finalize, counted also under ``bn_totals_fwd``
and ``bn_totals_bwd``.
The backward returns this process's own totals as dscale, dbias and dalpha
(the trainer's one gradient all-reduce sums them) and uses the global
means in dx. The plain versions take the same all-reduce. Every process
must bring the same number of rows. Without a group each call launches
three kernels, as before.

:func:`bn_prelu_eval` is the eval apply of the ResNet trunk's BN + PReLU
sites: one kernel, one pass, the running statistics (an :class:`EvalBN`), in
three forms: ``prelu(bn(x))``, ``prelu(bn(x) + residual)`` and
``prelu(bn(x) + residual_bn(residual))``. It computes the eager ops'
numbers, ``TorchBatchNorm``'s eval op order, the residual add and
``where(z >= 0, z, α·z)``, each op rounded in the activation's type as the
eager op rounds it, so an f32 or bf16 activation gets the eager result bit
for bit. It takes what the other wrappers take (the residual as ``x``'s
twin) and counts its launch under ``bn_prelu_eval``; on a CPU tensor it
runs :func:`bn_prelu_eval_reference`, the eager ops themselves.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from deeplip_tpu_torch.core.mesh import all_reduce, global_rows
from deeplip_tpu_torch.ops.cuda import build

_THREADS = 256        # threads of a partial-pass block (csrc kThreads)
_MAX_CHUNKS = 1056    # partial-pass blocks: 132 SMs x 8 resident blocks
_KERNEL_TYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_FWD, _BWD = ("bn_prelu_fwd",), ("bn_prelu_bwd",)
_FWD_TOTALS, _BWD_TOTALS = _FWD + ("bn_totals_fwd",), _BWD + ("bn_totals_bwd",)
_EVAL = ("bn_prelu_eval",)
_SIGNATURES = {   # entry -> (launch-count keys, argtypes)
    "bn_stats_partial": (_FWD, [_P, _I, _P, _L, _I, _L, _I, _P]),
    "bn_stats_finalize": (_FWD, [_P, _I, _I, _L, _F, _P, _P, _P, _P]),
    "bn_stats_totals": (_FWD_TOTALS, [_P, _I, _I, _P, _P]),
    "bn_stats_from_totals": (_FWD_TOTALS, [_P, _I, _L, _F, _P, _P, _P, _P]),
    "bn_prelu_apply": (_FWD, [_P, _I, _P, _P, _P, _P, _P, _P, _L, _I, _P]),
    "bn_prelu_bwd_partial": (_BWD, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _P]),
    "bn_prelu_bwd_finalize": (_BWD, [_P, _I, _I, _L, _P, _P, _P]),
    "bn_prelu_bwd_totals": (_BWD_TOTALS, [_P, _I, _I, _P, _P, _P]),
    "bn_prelu_bwd_from_totals": (_BWD_TOTALS, [_P, _I, _L, _P, _P]),
    "bn_prelu_bwd_apply": (_BWD, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P]),
    "bn_prelu_eval": (_EVAL, [_P, _P, _I, _I, _P, _P, _P, _P, _F, _P, _P, _P, _P, _F, _P, _P,
                              _L, _I, _P]),
}
_entry = build.entries("bn_prelu_kernel", _SIGNATURES)


def _work_type(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _reduced(x: torch.Tensor) -> tuple[tuple[int, ...], int]:
    return tuple(range(x.ndim - 1)), x.numel() // x.shape[-1]


def bn_prelu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       alpha: torch.Tensor, eps: float = 1e-5, group=None):
    """Plain PyTorch version of K3: ``(y, mean, var)``, with the op order of
    the JAX package's ``bn_prelu_reference`` (statistics in >= f32); under
    ``group`` the sums are all-reduced first (in the working type: a group of
    one gives the statistics of no group bit for bit)."""
    red = _reduced(x)[0]
    xf = x.to(_work_type(x))
    sums = all_reduce(torch.stack([xf.sum(red), (xf * xf).sum(red)]), group)
    n = global_rows(x, group)
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    z = ((xf - mean) * inv) * scale.to(xf.dtype) + bias.to(xf.dtype)
    y = torch.where(z >= 0, z, alpha.to(xf.dtype) * z)
    return y.to(x.dtype), mean, var


def bn_prelu_backward_reference(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                                inv: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, alpha: torch.Tensor, group=None):
    """Plain PyTorch version of K4, the analytic backward of
    :func:`bn_prelu_reference` with the ``mean``/``var`` cotangents taken as
    zero: ``(dx, dscale, dbias, dalpha)``; under ``group`` dx takes the
    all-reduced means, and the parameter sums stay this process's."""
    red, n = _reduced(x)
    wt = _work_type(x)
    xf, g = x.to(wt), dy.to(wt)
    scale, bias, alpha = scale.to(wt), bias.to(wt), alpha.to(wt)
    xhat = (xf - mean) * inv
    z = xhat * scale + bias
    neg = z < 0
    dz = torch.where(neg, alpha * g, g)
    dbias = dz.sum(red)
    dscale = (dz * xhat).sum(red)
    dalpha = torch.where(neg, g * z, torch.zeros_like(z)).sum(red)
    if group is None:
        mean_dz, mean_dzxh = dbias / n, dscale / n
    else:
        totals = all_reduce(torch.stack([dbias, dscale, dalpha]), group)
        n = global_rows(x, group)
        mean_dz, mean_dzxh = totals[0] / n, totals[1] / n
    dx = (inv * scale) * (dz - mean_dz - xhat * mean_dzxh)
    return dx.to(x.dtype), dscale, dbias, dalpha


def _check_cuda(x: torch.Tensor, params, what: str) -> None:
    if x.dtype not in _KERNEL_TYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 activations, got {x.dtype}")
    if x.ndim < 2 or not x.is_contiguous():
        raise ValueError(
            f"{what} takes an activation contiguous in (..., C) order (a "
            f"channels-last tensor's (rows, C) view), got shape {tuple(x.shape)} "
            f"strides {x.stride()}")
    c = x.shape[-1]
    if c % 4 or not 4 <= c <= 1024:
        raise ValueError(f"{what} takes C a multiple of 4 in [4, 1024], got C={c}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} needs a 16-byte aligned activation")
    for p in params:
        if (p.device != x.device or p.dtype != torch.float32 or p.shape != (c,)
                or not p.is_contiguous()):
            raise ValueError(
                f"{what} takes contiguous float32 ({c},) parameters on {x.device}, "
                f"got {p.dtype} {tuple(p.shape)} on {p.device}")


def _chunking(rows: int, c: int) -> tuple[int, int]:
    """``(rows_per_chunk, chunks)`` of the partial passes: at most
    ``_MAX_CHUNKS`` blocks, each a whole number of the block's row slots."""
    slots = _THREADS // (c // 4)
    per = -(-rows // _MAX_CHUNKS)
    per = -(-per // slots) * slots
    return per, -(-rows // per)


def _device_args(x: torch.Tensor):
    return _KERNEL_TYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream


def bn_prelu_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     alpha: torch.Tensor, eps: float = 1e-5, group=None):
    """K3: ``(y, mean, var, inv)``, global statistics under ``group``."""
    if x.device.type == "cpu":
        y, mean, var = bn_prelu_reference(x, scale, bias, alpha, eps, group)
        return y, mean, var, torch.rsqrt(var + eps)
    if x.device.type != "cuda":
        raise ValueError(f"bn_prelu_forward runs on cuda or cpu, not {x.device}")
    _check_cuda(x, (scale, bias, alpha), "bn_prelu_forward")
    c = x.shape[-1]
    rows = x.numel() // c
    per, chunks = _chunking(rows, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((chunks, 2, c), **f32)
    stats = torch.empty((3, c), **f32)
    mean, var, inv = stats[0], stats[1], stats[2]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        is_bf16, stream = _device_args(x)
        build.launch(_entry("bn_stats_partial"), x.data_ptr(), is_bf16, partial.data_ptr(),
                     rows, c, per, chunks, stream)
        if group is None:
            build.launch(_entry("bn_stats_finalize"), partial.data_ptr(), chunks, c, rows, eps,
                         mean.data_ptr(), var.data_ptr(), inv.data_ptr(), stream)
        else:
            totals = torch.empty((2, c), dtype=torch.float64, device=x.device)
            build.launch(_entry("bn_stats_totals"), partial.data_ptr(), chunks, c,
                         totals.data_ptr(), stream)
            all_reduce(totals, group)
            build.launch(_entry("bn_stats_from_totals"), totals.data_ptr(), c,
                         global_rows(x, group), eps, mean.data_ptr(), var.data_ptr(),
                         inv.data_ptr(), stream)
        build.launch(_entry("bn_prelu_apply"), x.data_ptr(), is_bf16, mean.data_ptr(),
                     inv.data_ptr(), scale.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
                     y.data_ptr(), rows, c, stream)
    return y, mean, var, inv


def bn_prelu_backward(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      alpha: torch.Tensor, group=None):
    """K4: ``(dx, dscale, dbias, dalpha)`` from the forward's ``mean`` and
    ``inv``; under ``group`` dx takes the global means and the parameter
    sums stay this process's."""
    if x.device.type == "cpu":
        return bn_prelu_backward_reference(x, dy, mean, inv, scale, bias, alpha, group)
    if x.device.type != "cuda":
        raise ValueError(f"bn_prelu_backward runs on cuda or cpu, not {x.device}")
    _check_cuda(x, (mean, inv, scale, bias, alpha), "bn_prelu_backward")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    _check_cuda(dy, (), "bn_prelu_backward")
    c = x.shape[-1]
    rows = x.numel() // c
    per, chunks = _chunking(rows, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((chunks, 3, c), **f32)
    sums = torch.empty((3, c), **f32)
    means = torch.empty((2, c), **f32)
    dx = torch.empty_like(x)
    ptrs = (mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            alpha.data_ptr())
    with torch.cuda.device(x.device):
        is_bf16, stream = _device_args(x)
        build.launch(_entry("bn_prelu_bwd_partial"), x.data_ptr(), dy.data_ptr(), is_bf16,
                     *ptrs, partial.data_ptr(), rows, c, per, chunks, stream)
        if group is None:
            build.launch(_entry("bn_prelu_bwd_finalize"), partial.data_ptr(), chunks, c, rows,
                         sums.data_ptr(), means.data_ptr(), stream)
        else:
            totals = torch.empty((3, c), dtype=torch.float64, device=x.device)
            build.launch(_entry("bn_prelu_bwd_totals"), partial.data_ptr(), chunks, c,
                         totals.data_ptr(), sums.data_ptr(), stream)
            all_reduce(totals, group)
            build.launch(_entry("bn_prelu_bwd_from_totals"), totals.data_ptr(), c,
                         global_rows(x, group), means.data_ptr(), stream)
        build.launch(_entry("bn_prelu_bwd_apply"), x.data_ptr(), dy.data_ptr(), is_bf16, *ptrs,
                     means.data_ptr(), dx.data_ptr(), rows, c, stream)
    return dx, sums[1], sums[0], sums[2]


class _BnPReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, alpha, eps, group):
        y, mean, var, inv = bn_prelu_forward(x, scale, bias, alpha, eps, group)
        ctx.save_for_backward(x, scale, bias, alpha, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        # the backward may run on autograd's device thread: the group goes
        # with the saved tensors, not through a context the step set
        ctx.group = group
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, bias, alpha, mean, inv = ctx.saved_tensors
        dx, dscale, dbias, dalpha = bn_prelu_backward(x, dy, mean, inv, scale, bias, alpha,
                                                      ctx.group)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype),
                dalpha.to(alpha.dtype), None, None)


def bn_prelu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   alpha: torch.Tensor, eps: float = 1e-5, group=None):
    """Fused train-mode BN (batch statistics, global under ``group``) +
    per-channel PReLU with K4 as its backward: ``(y, mean, var)``; ``var``
    is the biased batch variance for the caller's running update."""
    return _BnPReLUTrain.apply(x, scale, bias, alpha, eps, group)


class EvalBN(NamedTuple):
    """A BatchNorm in eval mode as :func:`bn_prelu_eval` reads it: the
    running ``mean`` and ``var``, ``scale`` (the BN's weight) and ``bias``,
    f32 ``(C,)``, and ``eps``."""
    mean: torch.Tensor
    var: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    eps: float


_NO_BN = EvalBN(None, None, None, None, 0.0)   # the unused second BN of forms 0 and 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def bn_eval_reference(x: torch.Tensor, bn: EvalBN) -> torch.Tensor:
    """``TorchBatchNorm``'s eval ops on a ``(..., C)`` activation, in its
    type: ``(x − mean)·rsqrt(var + eps)``, then ``·scale + bias``."""
    inv = torch.rsqrt(bn.var + bn.eps)
    y = (x - bn.mean.to(x.dtype)) * inv.to(x.dtype)
    return y * bn.scale.to(x.dtype) + bn.bias.to(x.dtype)


def bn_prelu_eval_reference(x: torch.Tensor, bn: EvalBN, alpha: torch.Tensor,
                            residual: torch.Tensor | None = None,
                            residual_bn: EvalBN | None = None) -> torch.Tensor:
    """Plain version of the eval apply, the eager ops it replaces:
    ``z = bn(x)``, plus ``residual`` (through ``residual_bn`` if given),
    then the PReLU ``where(z >= 0, z, α·z)``."""
    z = bn_eval_reference(x, bn)
    if residual is not None:
        z = z + (residual if residual_bn is None else bn_eval_reference(residual, residual_bn))
    return torch.where(z >= 0, z, alpha.to(z.dtype) * z)


def bn_prelu_eval(x: torch.Tensor, bn: EvalBN, alpha: torch.Tensor,
                  residual: torch.Tensor | None = None,
                  residual_bn: EvalBN | None = None) -> torch.Tensor:
    """The eval apply: ``prelu(bn(x) [+ residual | + residual_bn(residual)])``
    with the running statistics, in one pass; ``residual`` has ``x``'s shape,
    type and layout."""
    if residual is None and residual_bn is not None:
        raise ValueError("bn_prelu_eval: residual_bn without a residual")
    if x.device.type == "cpu":
        return bn_prelu_eval_reference(x, bn, alpha, residual, residual_bn)
    if x.device.type != "cuda":
        raise ValueError(f"bn_prelu_eval runs on cuda or cpu, not {x.device}")
    _check_cuda(x, (*bn[:4], alpha), "bn_prelu_eval")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device):
            raise ValueError(f"residual {residual.dtype} {tuple(residual.shape)} does not "
                             f"match x {x.dtype} {tuple(x.shape)}")
        _check_cuda(residual, residual_bn[:4] if residual_bn is not None else (),
                    "bn_prelu_eval")
    form = 0 if residual is None else 1 if residual_bn is None else 2
    bn_d = residual_bn if residual_bn is not None else _NO_BN
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = x.shape[-1]
    with torch.cuda.device(x.device):
        is_bf16, stream = _device_args(x)
        build.launch(_entry("bn_prelu_eval"), x.data_ptr(), _ptr(residual), is_bf16, form,
                     *map(_ptr, bn[:4]), bn.eps, *map(_ptr, bn_d[:4]), bn_d.eps,
                     alpha.data_ptr(), y.data_ptr(), x.numel() // c, c, stream)
    return y
