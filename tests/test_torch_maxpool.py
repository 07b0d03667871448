"""The Lipreading frontend's max-pool: the port's plain version (what the
CUDA kernel is held against on the card) against the JAX package's pool,
``flax.linen.max_pool`` with the frontend's window, stride and padding, and
its gradient against ``jax.vjp`` of the same call, ties included."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.ops.cuda import maxpool as P

torch.set_num_threads(1)


def _jax_pool(x):
    # deeplip_tpu/models/lipreading.py:158-161
    return nn.max_pool(x, window_shape=(1, 3, 3), strides=(1, 2, 2),
                       padding=[(0, 0), (1, 1), (1, 1)])


def _inputs(shape, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "negative":
        # every value below zero: a zero-padded pool would return zeros at
        # the border, a -inf-padded one never does
        x = -np.abs(x) - 0.1
    elif kind == "const_frames":
        # pad frames as the frontend hands them over: one constant per
        # channel over a whole frame, so every window of it ties
        x[:, 1::2] = rng.standard_normal(shape[-1]).astype(np.float32)
    elif kind == "repeats":
        # a coarse grid of values: most windows hold their maximum twice
        x = np.round(x * 2) / 2
    return x


CASES = [((2, 5, 44, 44, 8), "random"), ((1, 3, 43, 45, 4), "random"),
         ((2, 3, 12, 12, 4), "negative"), ((2, 4, 12, 14, 4), "const_frames"),
         ((2, 3, 11, 12, 4), "repeats")]


@pytest.mark.parametrize("shape, kind", CASES)
def test_plain_pool_is_bit_equal_to_flax(shape, kind):
    x = _inputs(shape, kind, 0)
    want = np.asarray(_jax_pool(jnp.asarray(x)))
    got = P.maxpool_frontend_reference(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (
        shape[0], shape[1], P.pooled_size(shape[2]), P.pooled_size(shape[3]), shape[4])
    # a maximum is one of its inputs: no rounding, so f32 results are equal
    np.testing.assert_array_equal(got, want)
    if kind == "negative":
        assert got.max() < 0.0


@pytest.mark.parametrize("shape, kind", CASES)
def test_plain_pool_gradient_matches_jax_vjp(shape, kind):
    x = _inputs(shape, kind, 1)
    rng = np.random.default_rng(2)
    y, vjp = jax.vjp(_jax_pool, jnp.asarray(x))
    dy = rng.standard_normal(y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(P.maxpool_frontend(xt), xt, torch.from_numpy(dy))
    # Both route each window's gradient to the first maximum in row-major
    # window order (XLA's select-and-scatter with a >= select, ATen's
    # strict > update), so tied windows agree too. A pixel sums at most
    # four windows' gradients, in an order that may differ: 1e-6.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if kind in ("const_frames", "repeats"):
        assert len(np.unique(x)) < 0.6 * x.size  # the data does hold repeated values


def test_tied_window_sends_its_gradient_to_the_first_maximum():
    x = np.zeros((1, 1, 4, 4, 4), np.float32)
    dy = np.ones((1, 1, 2, 2, 4), np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(P.maxpool_frontend(xt), xt, torch.from_numpy(dy))
    (want,) = jax.vjp(_jax_pool, jnp.asarray(x))[1](jnp.asarray(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # window (i, j) starts at (2i-1, 2j-1): its first in-frame tap is
    # (max(2i-1, 0), max(2j-1, 0))
    expect = np.zeros((4, 4), np.float32)
    for i in range(2):
        for j in range(2):
            expect[max(2 * i - 1, 0), max(2 * j - 1, 0)] += 1.0
    np.testing.assert_array_equal(got.numpy()[0, 0, :, :, 0], expect)


def test_plain_pool_propagates_nan():
    x = _inputs((1, 2, 8, 8, 4), "random", 3)
    x[0, 1, 3, 4, 2] = np.nan
    y = P.maxpool_frontend_reference(torch.from_numpy(x)).numpy()
    # pixel (3, 4) lies in windows i in {1, 2}, j = 2 of channel 2
    assert np.isnan(y[0, 1, 1:3, 2, 2]).all()
    assert int(np.isnan(y).sum()) == 2


def test_cpu_route_of_the_op_is_the_plain_version():
    x = torch.from_numpy(_inputs((2, 3, 10, 12, 8), "random", 4))
    assert torch.equal(P.maxpool_frontend(x), P.maxpool_frontend_reference(x))
    counts = P.maxpool_forward.launches, P.maxpool_backward.launches
    P.maxpool_frontend(x.requires_grad_(True)).sum().backward()
    assert (P.maxpool_forward.launches, P.maxpool_backward.launches) == counts


def test_model_frontend_calls_the_op(monkeypatch):
    seen = []
    op = P.maxpool_frontend
    monkeypatch.setattr(P, "maxpool_frontend", lambda x: (seen.append(tuple(x.shape)), op(x))[1])
    net = Lipreading(num_classes=3, hidden_dim=8, tcn_num_layers=1, trunk_layers=(1, 1, 1, 1))
    with torch.no_grad():
        net.eval().frame_features(torch.zeros(1, 2, 24, 24, 1))
    assert seen == [(1, 2, 12, 12, 64)]


@pytest.mark.parametrize("bad, error", [
    ("cpu", ValueError), ("float64", TypeError), ("channels_first", ValueError),
    ("four_dims", ValueError), ("odd_channels", ValueError)])
def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(bad, error):
    """The checks run before any launch, so they are reachable without a
    card: a tensor subclass that reports a CUDA device stands in for a
    CUDA tensor where the device check must pass."""
    x = torch.zeros((2, 3, 8, 8, 8))
    if bad == "cpu":
        with pytest.raises(error, match="cuda"):
            P.maxpool_forward(x)
        return

    class OnCard(torch.Tensor):
        """Reports a CUDA device; holds no CUDA memory."""
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = {"float64": x.double(), "channels_first": x.movedim(-1, 1).contiguous().movedim(1, -1),
         "four_dims": x[0], "odd_channels": x[..., :6].contiguous()}[bad]
    with pytest.raises(error):
        P.maxpool_forward(x.as_subclass(OnCard))
