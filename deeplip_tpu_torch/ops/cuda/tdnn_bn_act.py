"""Fused BatchNorm + LeakyReLU of the TDNN blocks (T): wrappers of
``csrc/tdnn_bn_act_kernel.cu``.

No TPU kernel: XLA fuses ``deeplip_tpu/models/tdnn.py``'s bias add, BN and
LeakyReLU on the TPU. On the card they ran as separate eager passes over
each block's Conv1d output; T does the same arithmetic in a few passes over
that output in its own ``(B, C, T)`` layout, and writes ``(B, C, T)``. It
takes the conv's output without its bias and adds the bias itself (``x +
conv_bias`` in the activation's type, as the convolution adds it), so the
convolution's separate bias pass and bias-gradient reduction go too.

- :func:`tdnn_bn_act_forward`, the train forward: ``(y, mean, var, inv)``,
  the batch statistics of ``x + conv_bias`` per channel over the ``B x T``
  elements (biased variance, two-pass, in >= f32) and ``y = leaky((x −
  μ)·inv·scale + bias)`` in ``TorchBatchNorm``'s op order.
- :func:`tdnn_bn_act_backward`: ``(dx, dconv_bias, dscale, dbias)``,
  autograd's gradient of those ops, recomputing the chain from ``x``, so
  the forward saves only ``x`` and the statistics.
- :func:`tdnn_bn_act_train` is the autograd op over the two: ``(y, mean,
  var)``; ``mean`` and ``var`` feed the caller's running update and carry no
  gradient.
- :func:`tdnn_bn_act_eval`: ``y`` from the running statistics, in the eager
  op order ``(x − mean)·rsqrt(var + eps)·scale + bias``, then LeakyReLU, so
  an f32 activation gets the eager ops' result.

On a CUDA tensor each wrapper launches the kernels on the current stream, or
raises: it takes an f32 or bf16 ``(B, C, T)`` activation, contiguous, and
f32 ``(C,)`` parameters; no copy is made for the caller. On a CPU tensor it
runs the plain version (``*_reference``). The train forward launches three
kernels a call (a partial pass, a finalize, an apply), the backward four
(the same three and the conv bias's gradient), the eval one;
``build.LAUNCHES`` counts them under ``tdnn_fwd``, ``tdnn_bwd`` and
``tdnn_eval``.

Rounding follows the blocks' eager ops, the recipe of ``models/norm.py``:
statistics in >= f32, the normalisation op by op in the activation's type,
so a bf16 activation is normalised in bf16 as before, and the backward
rounds where autograd of those ops rounds. The gradients of the blocks'
convolution biases, zero in exact arithmetic, are that rounding's noise in
a bf16 step, and keep its size: a fused op that normalised in f32 and
rounded ``y`` and ``dx`` once made them smaller, which the benchmark's
first-gradient check read as a gap of 0.16–0.18 of the reference's against
its limit of 0.2.

The statistics' partial and finalize passes are apart, so a process
group's all-reduce could go between them as in ``bn_prelu``; no group is
taken yet (the blocks keep the eager ops under one).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplip_tpu_torch.ops.cuda import build

_KERNEL_TYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_FWD, _BWD, _EVAL = ("tdnn_fwd",), ("tdnn_bwd",), ("tdnn_eval",)
_SIGNATURES = {   # entry -> (launch-count keys, argtypes)
    "tdnn_bn_stats": (_FWD, [_P, _I, _P, _P, _L, _I, _I, _P]),
    "tdnn_bn_finalize": (_FWD, [_P, _I, _I, _I, _F, _P, _P, _P, _P]),
    "tdnn_bn_act_apply": (_FWD, [_P, _I, _P, _P, _P, _P, _P, _F, _P, _L, _I, _I, _P]),
    "tdnn_bn_act_eval": (_EVAL, [_P, _I, _P, _P, _P, _F, _P, _P, _F, _P, _L, _I, _I, _P]),
    "tdnn_bn_act_bwd_stats": (_BWD, [_P, _P, _I, _P, _P, _P, _P, _P, _F, _P, _L, _I, _I, _P]),
    "tdnn_bn_act_bwd_finalize": (_BWD, [_P, _I, _I, _I, _I, _P, _P, _P, _P]),
    "tdnn_bn_act_bwd_apply": (_BWD, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _F, _P, _P, _L, _I,
                                     _I, _P]),
    "tdnn_bn_act_bwd_cbias": (_BWD, [_P, _I, _I, _I, _P, _P]),
}
_entry = build.entries("tdnn_bn_act_kernel", _SIGNATURES)
_BWD_SUMS = 5   # the backward's per-row sums (csrc kBwdSums)


def _col(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A ``(C,)`` vector cast to ``dtype`` as ``(C, 1)``, to broadcast over
    ``(B, C, T)``."""
    return v.to(dtype)[:, None]


def _chain(x: torch.Tensor, mean, inv, scale, bias):
    """``TorchBatchNorm``'s normalisation of ``x`` in ``x``'s type: ``a = x −
    mean``, ``y1 = a·inv``, ``z = y1·scale + bias``, each op rounded to that
    type."""
    a = x - _col(mean, x.dtype)
    y1 = a * _col(inv, x.dtype)
    return a, y1, y1 * _col(scale, x.dtype) + _col(bias, x.dtype)


def tdnn_bn_act_reference(x: torch.Tensor, conv_bias: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5, slope: float = 0.2, at=None):
    """Plain version of the train forward: ``(y, mean, var)`` on a ``(B, C,
    T)`` conv output without its bias: ``x + conv_bias`` in ``x``'s type, its
    statistics over axes 0 and 2 by the two-pass rule of ``models/norm.py``
    in >= f32, then the normalisation and LeakyReLU as ``TorchBatchNorm`` and
    ``F.leaky_relu`` compute them in ``x``'s type. ``at``, a ``(mean, inv)``
    pair, gives the values the normalisation takes in place of the batch's
    own, whose gradient it keeps."""
    x = x + _col(conv_bias, x.dtype)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean((0, 2))
    var = ((xf - mean[:, None]) ** 2).mean((0, 2))
    inv = torch.rsqrt(var + eps)
    m, i = (mean, inv) if at is None else (mean + (at[0] - mean).detach(),
                                           inv + (at[1] - inv).detach())
    return F.leaky_relu(_chain(x, m, i, scale, bias)[2], slope), mean, var


def tdnn_bn_act_backward_reference(x: torch.Tensor, dy: torch.Tensor, conv_bias: torch.Tensor,
                                   mean: torch.Tensor, inv: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor, slope: float = 0.2, eps: float = 1e-5):
    """Plain version of the train backward: ``(dx, dconv_bias, dscale,
    dbias)``, autograd's gradient through :func:`tdnn_bn_act_reference`'s
    ops at the forward's statistics ``mean`` and ``inv`` (so LeakyReLU's mask
    is the forward's where ``z`` rounds near zero), the ``mean``/``var``
    outputs' cotangents taken as zero; the parameters' gradients in >= f32."""
    wt = torch.promote_types(x.dtype, torch.float32)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)] + [
            p.detach().to(wt).requires_grad_(True) for p in (conv_bias, scale, bias)]
        y = tdnn_bn_act_reference(*leaves, eps, slope, at=(mean, inv))[0]
        return torch.autograd.grad(y, leaves, dy)


def tdnn_bn_act_eval_reference(x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
                               var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               eps: float = 1e-5, slope: float = 0.2) -> torch.Tensor:
    """Plain version of the eval apply: ``x + conv_bias``, then
    ``TorchBatchNorm``'s eval ops on ``(B, C, T)``, ``(x − mean)·rsqrt(var +
    eps)·scale + bias`` in ``x``'s type, then LeakyReLU."""
    inv = torch.rsqrt(var + eps)
    x = x + _col(conv_bias, x.dtype)
    return F.leaky_relu(_chain(x, mean, inv, scale, bias)[2], slope)


def _check_cuda(x: torch.Tensor, params, what: str) -> None:
    if x.dtype not in _KERNEL_TYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 activations, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{what} takes a non-empty contiguous (B, C, T) activation, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[1]
    for p in params:
        if (p.device != x.device or p.dtype != torch.float32 or p.shape != (c,)
                or not p.is_contiguous()):
            raise ValueError(
                f"{what} takes contiguous float32 ({c},) parameters on {x.device}, "
                f"got {p.dtype} {tuple(p.shape)} on {p.device}")


def _device_args(x: torch.Tensor):
    return _KERNEL_TYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream


def _on(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernels), False for a CPU tensor
    (run the plain version)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return x.device.type == "cuda"


def tdnn_bn_act_forward(x: torch.Tensor, conv_bias: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-5, slope: float = 0.2):
    """The train forward: ``(y, mean, var, inv)``."""
    if not _on(x, "tdnn_bn_act_forward"):
        y, mean, var = tdnn_bn_act_reference(x, conv_bias, scale, bias, eps, slope)
        return y, mean, var, torch.rsqrt(var + eps)
    _check_cuda(x, (conv_bias, scale, bias), "tdnn_bn_act_forward")
    b, c, t = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((2, b * c), **f32)
    stats = torch.empty((3, c), **f32)
    mean, var, inv = stats[0], stats[1], stats[2]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        is_bf16, stream = _device_args(x)
        build.launch(_entry("tdnn_bn_stats"), x.data_ptr(), is_bf16, conv_bias.data_ptr(),
                     partial.data_ptr(), b * c, c, t, stream)
        build.launch(_entry("tdnn_bn_finalize"), partial.data_ptr(), b, c, t, eps,
                     mean.data_ptr(), var.data_ptr(), inv.data_ptr(), stream)
        build.launch(_entry("tdnn_bn_act_apply"), x.data_ptr(), is_bf16, conv_bias.data_ptr(),
                     mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(), slope,
                     y.data_ptr(), b * c, c, t, stream)
    return y, mean, var, inv


def tdnn_bn_act_backward(x: torch.Tensor, dy: torch.Tensor, conv_bias: torch.Tensor,
                         mean: torch.Tensor, inv: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, slope: float = 0.2, eps: float = 1e-5):
    """The train backward: ``(dx, dconv_bias, dscale, dbias)`` from the
    forward's ``mean`` and ``inv`` (``eps``, the forward's, for the plain
    version's autograd)."""
    if not _on(x, "tdnn_bn_act_backward"):
        return tdnn_bn_act_backward_reference(x, dy, conv_bias, mean, inv, scale, bias, slope,
                                              eps)
    _check_cuda(x, (conv_bias, mean, inv, scale, bias), "tdnn_bn_act_backward")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    _check_cuda(dy, (), "tdnn_bn_act_backward")
    b, c, t = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((_BWD_SUMS, b * c), **f32)
    cb_partial = torch.empty((b * c,), **f32)
    sums = torch.empty((3, c), **f32)   # dbias, dscale, dconv_bias
    coef = torch.empty((2, c), **f32)
    dx = torch.empty_like(x)
    ptrs = (conv_bias.data_ptr(), mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
            bias.data_ptr())
    with torch.cuda.device(x.device):
        is_bf16, stream = _device_args(x)
        build.launch(_entry("tdnn_bn_act_bwd_stats"), x.data_ptr(), dy.data_ptr(), is_bf16,
                     *ptrs, slope, partial.data_ptr(), b * c, c, t, stream)
        build.launch(_entry("tdnn_bn_act_bwd_finalize"), partial.data_ptr(), is_bf16, b, c, t,
                     inv.data_ptr(), sums.data_ptr(), coef.data_ptr(), stream)
        build.launch(_entry("tdnn_bn_act_bwd_apply"), x.data_ptr(), dy.data_ptr(), is_bf16,
                     *ptrs, coef.data_ptr(), slope, dx.data_ptr(), cb_partial.data_ptr(),
                     b * c, c, t, stream)
        build.launch(_entry("tdnn_bn_act_bwd_cbias"), cb_partial.data_ptr(), is_bf16, b, c,
                     sums[2].data_ptr(), stream)
    return dx, sums[2], sums[1], sums[0]


def tdnn_bn_act_eval(x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5, slope: float = 0.2) -> torch.Tensor:
    """The eval apply with the running ``mean`` and ``var``."""
    if not _on(x, "tdnn_bn_act_eval"):
        return tdnn_bn_act_eval_reference(x, conv_bias, mean, var, scale, bias, eps, slope)
    _check_cuda(x, (conv_bias, mean, var, scale, bias), "tdnn_bn_act_eval")
    b, c, t = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        is_bf16, stream = _device_args(x)
        build.launch(_entry("tdnn_bn_act_eval"), x.data_ptr(), is_bf16, conv_bias.data_ptr(),
                     mean.data_ptr(), var.data_ptr(), eps, scale.data_ptr(), bias.data_ptr(),
                     slope, y.data_ptr(), b * c, c, t, stream)
    return y


class _TdnnBnActTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, conv_bias, scale, bias, eps, slope):
        y, mean, var, inv = tdnn_bn_act_forward(x, conv_bias, scale, bias, eps, slope)
        ctx.save_for_backward(x, conv_bias, scale, bias, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        ctx.eps, ctx.slope = eps, slope
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, conv_bias, scale, bias, mean, inv = ctx.saved_tensors
        # the gradient of the block's (B, T, C) view may come in another layout
        dx, dcb, dscale, dbias = tdnn_bn_act_backward(x, dy.contiguous(), conv_bias, mean, inv,
                                                      scale, bias, ctx.slope, ctx.eps)
        return (dx, dcb.to(conv_bias.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype),
                None, None)


def tdnn_bn_act_train(x: torch.Tensor, conv_bias: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5, slope: float = 0.2):
    """Fused train-mode conv bias + BN (batch statistics) + LeakyReLU on a
    ``(B, C, T)`` conv output without its bias, with the backward kernels as
    its backward: ``(y, mean, var)``; ``var`` is the biased batch variance
    for the caller's running update."""
    return _TdnnBnActTrain.apply(x, conv_bias, scale, bias, eps, slope)
