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
from deeplip_tpu_torch.ops.cuda import launch_counts
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
    counts = launch_counts()
    P.maxpool_frontend(x.requires_grad_(True)).sum().backward()
    assert launch_counts() == counts


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


# ------------------------------------------------ the backward kernel's plain twins
# Edges of the backward's 2x2 patches: odd and even frames, frames of one to
# three pixels, and widths that take the 8-wide bf16 route (24, 64) or the
# 4-wide one (4, 12).
EDGE_SIDES = (1, 2, 3, 43, 45)
EDGE_CHANNELS = (4, 12, 24, 64)
EDGE_FRAMES = [(h, w, EDGE_CHANNELS[(a + b) % 4])
               for a, h in enumerate(EDGE_SIDES) for b, w in enumerate(EDGE_SIDES)]
EDGE_FRAMES += [(43, 45, c) for c in EDGE_CHANNELS]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32)


def _jax_dx(x, dy):
    (want,) = jax.vjp(_jax_pool, jnp.asarray(x))[1](jnp.asarray(dy))
    return np.asarray(want)


def _pool_grad(x, dy):
    """F.max_pool3d's autograd backward on the CPU."""
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(P.maxpool_frontend_reference(xt), xt, torch.from_numpy(dy))
    return dx.numpy()


def _dy_for(shape, seed):
    n, t, h, w, c = shape
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, t, P.pooled_size(h), P.pooled_size(w), c)).astype(np.float32)


def _plain_dx(x, dy):
    pos = P.maxpool_positions_reference(torch.from_numpy(x))
    return P.maxpool_backward_reference(torch.from_numpy(dy), pos, x.shape).numpy()


@pytest.mark.parametrize("shape, kind", CASES)
def test_backward_reference_is_bit_equal_to_jax_vjp(shape, kind):
    x = _inputs(shape, kind, 5)
    dy = _dy_for(shape, 6)
    got, want = _plain_dx(x, dy), _jax_dx(x, dy)
    # the existing vjp bar, and bit-equal besides: XLA, ATen and the kernel
    # all add a pixel's (at most four) windows in (i, j) order from 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_pool_grad(x, dy)))


@pytest.mark.parametrize("h, w, c", EDGE_FRAMES)
@pytest.mark.parametrize("kind", ["random", "repeats"])
def test_backward_reference_at_the_patch_edges(h, w, c, kind):
    shape = (1, 2, h, w, c)
    x = _inputs(shape, kind, 7)
    dy = _dy_for(shape, 8)
    got = _plain_dx(x, dy)
    want = _jax_dx(x, dy)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_pool_grad(x, dy)))


@pytest.mark.parametrize("h, w, c", [(1, 1, 4), (2, 3, 12), (3, 2, 24), (43, 45, 64)])
def test_positions_reference_is_the_index_max_pool3d_returns(h, w, c):
    shape = (2, 3, h, w, c)
    x = _inputs(shape, "repeats", 9)
    x[0, 1, h // 2, w // 2, 1] = np.nan
    x[1, 2, 0, w - 1, 0] = np.nan
    x[1, 0, h - 1, 0, c - 1] = -np.inf
    x[1, 1] = -np.inf       # a frame of -inf: the first tap inside the frame wins
    _, idx = torch.nn.functional.max_pool3d(
        torch.from_numpy(x).movedim(-1, 1), (1, 3, 3), (1, 2, 2), (0, 1, 1),
        return_indices=True)
    idx = idx.movedim(1, -1) % (h * w)
    i = torch.arange(P.pooled_size(h))[:, None, None]
    j = torch.arange(P.pooled_size(w))[None, :, None]
    tap = (idx // w - (2 * i - 1)) * 3 + (idx % w - (2 * j - 1))
    pos = P.maxpool_positions_reference(torch.from_numpy(x))
    assert pos.dtype == torch.uint8 and torch.equal(pos, tap.to(torch.uint8))
    assert int(pos.max()) <= 8


def test_backward_reference_with_nan_windows():
    """A NaN tap holds its window's maximum (the last NaN in row-major
    order, as ATen takes it), so the window's gradient goes to it: bit-equal
    to F.max_pool3d's autograd. XLA's select never picks a NaN, so JAX
    routes such a window elsewhere; away from those windows it agrees."""
    shape = (2, 2, 12, 13, 8)
    x = _inputs(shape, "repeats", 10)
    x[0, 1, 5, 6, 3] = np.nan
    x[0, 1, 5, 7, 3] = np.nan     # two NaN in one window: the later one wins
    x[1, 0, 0, 12, 0] = np.nan
    dy = _dy_for(shape, 11)
    got = _plain_dx(x, dy)
    np.testing.assert_array_equal(_bits(got), _bits(_pool_grad(x, dy)))
    # pixel (5, 7) is the later NaN of windows (2..3, 3..4): it takes all
    # four windows' dy, added in (i, j) order, and (5, 6) gets none
    pos = P.maxpool_positions_reference(torch.from_numpy(x)).numpy()
    assert [pos[0, 1, i, j, 3] for i in (2, 3) for j in (3, 4)] == [8, 6, 2, 0]
    acc = np.float32(0)
    for i in (2, 3):
        for j in (3, 4):
            acc = np.float32(acc + dy[0, 1, i, j, 3])
    assert _bits(got[0, 1, 5, 7, 3:4]) == _bits(np.array([acc], np.float32))
    assert got[0, 1, 5, 6, 3] == 0.0
    near = np.zeros(shape, bool)   # the pixels of the windows that hold a NaN
    near[0, 1, 3:8, 5:10, 3] = True
    near[1, 0, 0:2, 11:13, 0] = True
    want = _jax_dx(x, dy)
    np.testing.assert_array_equal(_bits(got[~near]), _bits(want[~near]))
    assert not np.array_equal(got[near], want[near])


def test_backward_reference_bf16_is_the_f32_sum_rounded_once():
    shape = (2, 3, 21, 22, 16)
    x = _inputs(shape, "const_frames", 12)
    pos = P.maxpool_positions_reference(torch.from_numpy(x))
    dy = torch.from_numpy(_dy_for(shape, 13)).to(torch.bfloat16)
    got = P.maxpool_backward_reference(dy, pos, shape)
    assert got.dtype == torch.bfloat16
    f32 = P.maxpool_backward_reference(dy.float(), pos, shape)
    assert torch.equal(got.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16))
    # the same sums rounded after each addition land elsewhere: the test
    # tells the two apart
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    (per_add,) = torch.autograd.grad(P.maxpool_frontend_reference(xt), xt, dy)
    assert not torch.equal(got, per_add)


def _tiles(h, w, c, dtype):
    """The backward launch's tile (``maxpool_backward`` in the ``.cu``):
    ``(rows, cols, chans)`` of windows and channels, from the wrapper's
    constants. Whole window rows where two rows and their halo fit the
    stage, else ``BWD_ROWS`` rows of as many columns as fit, else of one
    column and as many channels as fit."""
    wo = P.pooled_size(w)
    item, lanes = dtype.itemsize, P.backward_lanes(dtype, c)
    budget, unit = P.BWD_STAGE_BYTES - 16, c * (item + 1)
    if 2 * wo * unit <= budget:
        return min(P.BWD_ROWS, budget // (wo * unit) - 1), wo, c
    cols = budget // ((P.BWD_ROWS + 1) * unit) - 1
    if cols >= 1:
        return P.BWD_ROWS, cols, c
    return P.BWD_ROWS, 1, budget // (2 * (P.BWD_ROWS + 1) * (item + 1)) // lanes * lanes


def _ownership(h, w, c, dtype):
    """How many times the backward kernel writes each ``(h, w, c)`` of one
    frame, and the most shared memory a block stages: a twin of its launch
    and of each block's stage and items, from the wrapper's constants."""
    ho, wo = P.pooled_size(h), P.pooled_size(w)
    lanes = P.backward_lanes(dtype, c)
    t_rows, t_cols, t_chans = _tiles(h, w, c, dtype)
    stage = (t_rows + 1) * min(t_cols + 1, wo) * t_chans
    smem = -(-stage * dtype.itemsize // 16) * 16 + stage
    writes = np.zeros((h, w, c), np.int64)
    for i0 in range(0, ho, t_rows):
        for j0 in range(0, wo, t_cols):
            for c0 in range(0, c, t_chans):
                rows, cols = min(t_rows, ho - i0), min(t_cols, wo - j0)
                srows, scols = min(t_rows + 1, ho - i0), min(t_cols + 1, wo - j0)
                chans = min(t_chans, c - c0)
                assert chans % lanes == 0
                item = np.arange(rows * cols * (chans // lanes))
                r, q = item // (cols * (chans // lanes)), item % (cols * (chans // lanes))
                i, j = i0 + r, j0 + q // (chans // lanes)
                ch = c0 + (q % (chans // lanes)) * lanes
                # the staged windows a thread reads: (r, jl) and its right
                # and lower neighbours, where they exist
                assert ((r + (i + 1 < ho)) < srows).all()
                assert ((q // (chans // lanes) + (j + 1 < wo)) < scols).all()
                for dr in (0, 1):
                    for ds in (0, 1):
                        ok = (2 * i + dr < h) & (2 * j + ds < w)
                        for k in range(lanes):
                            np.add.at(writes, (2 * i[ok] + dr, 2 * j[ok] + ds, ch[ok] + k), 1)
    return writes, smem, lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, w, c", EDGE_FRAMES + [
    (44, 44, 64), (44, 44, 24), (88, 88, 12), (9, 600, 64), (5, 6, 4096), (3, 4, 548)])
def test_backward_threads_write_every_pixel_once(h, w, c, dtype):
    """Every input pixel of a frame is written by exactly one thread, at the
    patch edges and in each tiling: whole rows (44 x 44), columns (a
    600-pixel width) and channels (4,096 channels, the last tile
    narrower)."""
    writes, smem, lanes = _ownership(h, w, c, dtype)
    assert (writes == 1).all()
    assert smem <= P.BWD_STAGE_BYTES
    # 16 bytes a thread, but 8 for bf16 with c % 8 == 4
    assert lanes * dtype.itemsize == (8 if dtype == torch.bfloat16 and c % 8 else 16)


def test_backward_tiles_at_the_training_shapes():
    """Both frontends' frames stage whole window rows, which the kernel
    copies in bulk (TMA); a 600-pixel width stages columns, 4,096 channels
    one column of windows and a slice of the channels."""
    for c in (64, 24):
        for dtype in (torch.float32, torch.bfloat16):
            assert _tiles(44, 44, c, dtype) == (P.BWD_ROWS, 22, c)
    assert _tiles(9, 600, 64, torch.float32) == (P.BWD_ROWS, 50, 64)
    assert _tiles(5, 6, 4096, torch.float32) == (P.BWD_ROWS, 1, 1636)
    assert _tiles(5, 6, 4096, torch.bfloat16) == (P.BWD_ROWS, 1, 2728)


def test_tile_constants_are_the_kernels():
    src = open(P.build.CSRC_DIR / "maxpool_kernel.cu").read()
    assert f"constexpr int kBwdThreads = {P.BWD_THREADS};" in src
    assert f"constexpr int kBwdRows = {P.BWD_ROWS};" in src
    assert "constexpr int kBwdStageBytes = 48 * 1024 - 32;" in src
    assert P.BWD_STAGE_BYTES == 48 * 1024 - 32


@pytest.mark.parametrize("bad, error", [
    ("cpu", ValueError), ("float64", TypeError), ("channels_first", ValueError),
    ("four_dims", ValueError), ("odd_channels", ValueError), ("dy_shape", ValueError),
    ("pos_dtype", ValueError), ("pos_shape", ValueError), ("pos_strided", ValueError),
    ("pos_on_cpu", ValueError)])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    """The same refusals as before the kernel's redesign, checked before any
    launch (a CUDA-reporting subclass stands in for a card tensor)."""
    shape = (2, 3, 8, 8, 8)
    dy = torch.zeros((2, 3, 4, 4, 8))
    pos = torch.zeros((2, 3, 4, 4, 8), dtype=torch.uint8)
    if bad == "cpu":
        with pytest.raises(error, match="cuda"):
            P.maxpool_backward(dy, pos, shape)
        return

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    if bad == "float64":
        dy = dy.double()
    elif bad == "channels_first":
        dy = dy.movedim(-1, 1).contiguous().movedim(1, -1)
    elif bad == "four_dims":
        dy = dy[0]
    elif bad == "odd_channels":
        dy, pos, shape = dy[..., :6].contiguous(), pos[..., :6].contiguous(), shape[:4] + (6,)
    elif bad == "dy_shape":
        shape = (2, 3, 9, 6, 8)   # pools to (5, 3), not (4, 4)
    elif bad == "pos_dtype":
        pos = pos.to(torch.int16)
    elif bad == "pos_shape":
        pos = pos[:, :2]
    elif bad == "pos_strided":
        pos = pos.movedim(-1, 1).contiguous().movedim(1, -1)
    pos = pos if bad == "pos_on_cpu" else pos.as_subclass(OnCard)
    with pytest.raises(error):
        P.maxpool_backward(dy.as_subclass(OnCard), pos, shape)
