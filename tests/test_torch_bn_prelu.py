"""The port's fused train-mode BN+PReLU (K3 forward, K4 backward) against the
JAX package's Pallas kernel in interpret mode.

On the CPU the wrappers run their plain versions; the kernels themselves are
held against those plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.ops.pallas import bn_prelu_kernel as JK
from deeplip_tpu_torch.ops.cuda import bn_prelu as K
from deeplip_tpu_torch.ops.cuda import launch_counts

torch.set_num_threads(1)

SHAPES = [(6, 5, 4, 8), (2, 3, 4, 4, 8)]


def _inputs(shape, seed=0, mean_shift=0.7):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + mean_shift).astype(np.float32)
    scale = (0.5 + rng.random(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    alpha = np.full((c,), 0.25, np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, alpha, dy


def _t(*arrays, dtype=None):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_interpret(shape):
    x, scale, bias, alpha, _ = _inputs(shape)
    want = JK.bn_prelu_train(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                             jnp.asarray(alpha), 1e-5, True)
    launches = launch_counts()
    got = K.bn_prelu_train(*_t(x, scale, bias, alpha), 1e-5)
    assert launch_counts() == launches  # CPU tensors launch nothing
    for g, w, name in zip(got, want, ("y", "mean", "var")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6, rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_pallas_vjp(shape):
    x, scale, bias, alpha, dy = _inputs(shape, seed=1)
    _, vjp = jax.vjp(lambda *a: JK.bn_prelu_train(*a, 1e-5, True)[0],
                     *map(jnp.asarray, (x, scale, bias, alpha)))
    want = vjp(jnp.asarray(dy))
    args = _t(x, scale, bias, alpha)
    for a in args:
        a.requires_grad_(True)
    y, _, _ = K.bn_prelu_train(*args, 1e-5)
    launches = launch_counts()
    y.backward(torch.tensor(dy))
    assert launch_counts() == launches
    for a, w, name in zip(args, want, ("dx", "dscale", "dbias", "dalpha")):
        w = np.asarray(w)
        # the per-channel sums run over 120 (4-D) or 96 (5-D) rows in f32
        np.testing.assert_allclose(a.grad.numpy(), w, atol=2e-6 * max(1.0, np.abs(w).max()),
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_analytic_backward_is_autograd_of_plain_forward(shape):
    x, scale, bias, alpha, dy = _inputs(shape, seed=2)
    args = _t(x, scale, bias, alpha, dtype=torch.float64)
    for a in args:
        a.requires_grad_(True)
    y, mean, var = K.bn_prelu_reference(*args, 1e-5)
    y.backward(torch.tensor(dy, dtype=torch.float64))
    inv = torch.rsqrt(var + 1e-5).detach()
    got = K.bn_prelu_backward_reference(
        args[0].detach(), torch.tensor(dy, dtype=torch.float64), mean.detach(), inv,
        *(a.detach() for a in args[1:]))
    for g, a, name in zip(got, args, ("dx", "dscale", "dbias", "dalpha")):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), atol=1e-12, rtol=1e-10,
                                   err_msg=name)


def test_autograd_function_gradcheck_f64():
    x, scale, bias, alpha, _ = _inputs((3, 2, 3, 4), seed=3)
    args = [a.requires_grad_(True) for a in _t(x, scale, bias, alpha, dtype=torch.float64)]
    assert torch.autograd.gradcheck(lambda *a: K.bn_prelu_train(*a, 1e-5)[0], args,
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_statistics_carry_no_gradient():
    x, scale, bias, alpha, _ = _inputs((4, 3, 3, 8), seed=4)
    args = [a.requires_grad_(True) for a in _t(x, scale, bias, alpha)]
    y, mean, var = K.bn_prelu_train(*args, 1e-5)
    assert y.requires_grad and not mean.requires_grad and not var.requires_grad


def test_bf16_plain_version_computes_in_f32():
    x, scale, bias, alpha, dy = _inputs((4, 3, 3, 8), seed=5)
    xb, dyb = torch.tensor(x).bfloat16(), torch.tensor(dy).bfloat16()
    p = _t(scale, bias, alpha)
    y, mean, var, inv = K.bn_prelu_forward(xb, *p, 1e-5)
    yf, meanf, varf = K.bn_prelu_reference(xb.float(), *p, 1e-5)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    assert torch.equal(y, yf.bfloat16()) and torch.equal(mean, meanf)
    dx = K.bn_prelu_backward(xb, dyb, mean, inv, *p)[0]
    dxf = K.bn_prelu_backward_reference(xb.float(), dyb.float(), mean, inv, *p)[0]
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, dxf.bfloat16())


@pytest.mark.parametrize("shape", [(128, 29, 44, 44, 64), (3712, 22, 22, 64),
                                   (3712, 11, 11, 128), (3712, 6, 6, 256),
                                   (3712, 3, 3, 512), (5, 12), (1, 4)])
def test_partial_pass_chunking_covers_every_row(shape):
    c = shape[-1]
    rows = int(np.prod(shape[:-1]))
    per, chunks = K._chunking(rows, c)
    slots = K._THREADS // (c // 4)
    assert per % slots == 0 and chunks <= K._MAX_CHUNKS
    assert (chunks - 1) * per < rows <= chunks * per


@pytest.mark.parametrize("bad, err", [
    (lambda x: x.transpose(1, 2), ValueError),   # not (..., C)-contiguous
    (lambda x: x[..., :6], ValueError),          # C not a multiple of 4
    (lambda x: x.double(), TypeError),           # no f64 kernel
    (lambda x: x.reshape(-1), ValueError),       # 1-D
])
def test_kernel_guard_refuses_what_the_kernels_do_not_take(bad, err):
    x = bad(torch.zeros(2, 3, 4, 8))
    c = x.shape[-1]
    with pytest.raises(err):
        K._check_cuda(x, (torch.zeros(c),), "bn_prelu_forward")


def test_kernel_guard_refuses_mismatched_parameters():
    x = torch.zeros(2, 3, 4, 8)
    K._check_cuda(x, (torch.zeros(8),), "ok")
    for p in (torch.zeros(4), torch.zeros(8, dtype=torch.float64)):
        with pytest.raises(ValueError):
            K._check_cuda(x, (p,), "bn_prelu_forward")
