"""The TDNN blocks' fused conv bias + BatchNorm + LeakyReLU
(``ops/cuda/tdnn_bn_act``, T).

On the CPU: the plain versions against the conv's bias add,
``TorchBatchNorm`` and ``F.leaky_relu`` (train and eval, the running update
included) and against autograd of that composition; the bf16 rule (the
eager recipe's rounding, which keeps the conv biases' gradient noise at its
size); 1,500 channels and ragged lengths; and the route ``TDNNBlock`` takes
to T. The route runs on the CPU here by showing ``TDNNBlock.fused`` a CPU
activation as one on the card, which sends it through the wrappers' plain
versions.

The tests marked ``card`` hold the kernels to their plain versions, bit for
bit across runs and CUDA-graph replays; they skip without a card. On one:

    python -m pytest --noconftest -m card tests/test_torch_tdnn_bn_act.py
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from deeplip_tpu_torch.core.mesh import make_mesh
from deeplip_tpu_torch.models import tdnn
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet, TDNNBlock
from deeplip_tpu_torch.ops.cuda import tdnn_bn_act as T

torch.set_num_threads(2)

SLOPE = 0.2
EPS = 1e-5
# (B, C, T): a small case, the flagship's last width, ragged lengths
SHAPES = [(3, 8, 5), (2, 1500, 7), (4, 12, 13), (2, 4, 1)]
TOL = {torch.float64: 1e-12, torch.float32: 2e-6}   # of the largest |value|
CONTEXTS, HIDDEN = [[-2, -1, 0, 1, 2], [0], [-2, 0, 2], [0]], [16, 16, 16, 24]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _inputs(shape, dtype, seed=0):
    """A conv output without its bias, the conv bias (a per-channel
    offset) and random BN parameters."""
    rng = np.random.default_rng(seed)
    b, c, t = shape
    x = rng.standard_normal(shape) * rng.uniform(0.5, 3.0, (1, c, 1))
    f32 = dict(dtype=torch.float32)
    return (torch.tensor(x, dtype=dtype), torch.tensor(rng.normal(0, 2, c), **f32),
            torch.tensor(rng.uniform(0.5, 1.5, c), **f32),
            torch.tensor(rng.normal(0, 0.5, c), **f32))


def _bn(c: int, scale, bias, dtype=torch.float32, seed=1) -> TorchBatchNorm:
    rng = np.random.default_rng(seed)
    bn = TorchBatchNorm(c).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(scale)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(torch.tensor(rng.normal(0, 1, c)))
        bn.running_var.copy_(torch.tensor(rng.uniform(0.5, 2.0, c)))
    return bn


def _eager(bn: TorchBatchNorm, x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """The block's eager ops on the ``(B, C, T)`` conv output without its
    bias: the bias add in ``x``'s type, BN, LeakyReLU, as ``(B, C, T)``."""
    y = x + cb.to(x.dtype)[:, None]
    return F.leaky_relu(bn(y.transpose(1, 2)), SLOPE).transpose(1, 2)


class _AsOnCard:
    """What ``TDNNBlock.fused`` reads of a CPU activation, as if it were on
    the card."""
    is_cuda = True

    def __init__(self, x: torch.Tensor):
        self.dtype, self.requires_grad = x.dtype, x.requires_grad


@contextlib.contextmanager
def _fused_on_cpu(monkeypatch):
    """Route CPU activations through T (its plain versions) by the card's
    rule, counting the calls of the fused op."""
    calls = []
    fused, route = tdnn.bn_leaky_ncw, TDNNBlock.fused

    def counting(bn, y, conv_bias):
        calls.append(bn.training)
        return fused(bn, y, conv_bias)

    monkeypatch.setattr(TDNNBlock, "fused", lambda self, x: route(self, _AsOnCard(x)))
    monkeypatch.setattr(tdnn, "bn_leaky_ncw", counting)
    yield calls


# ---------------------------------------------------------------- plain versions
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_train_forward_matches_the_eager_ops_and_the_running_update(shape, dtype):
    x, cb, scale, bias = _inputs(shape, dtype)
    ours, eager = _bn(shape[1], scale, bias, dtype), _bn(shape[1], scale, bias, dtype)
    y, mean, var = T.tdnn_bn_act_reference(x, cb, ours.weight, ours.bias, EPS, SLOPE)
    ours.update_running(mean, var, x.numel() // x.shape[1])
    want = _eager(eager, x, cb)
    assert y.dtype == dtype and y.shape == x.shape
    assert _rel(y, want) <= TOL[dtype]
    xd = x.double() + cb.double()[:, None]
    assert _rel(mean, xd.mean((0, 2))) <= TOL[dtype]
    assert _rel(var, xd.var((0, 2), unbiased=False)) <= TOL[dtype]
    for name in ("running_mean", "running_var"):
        assert _rel(getattr(ours, name), getattr(eager, name)) <= TOL[dtype], name
    assert int(ours.num_batches_tracked) == int(eager.num_batches_tracked) == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_eval_is_the_eager_ops_bit_for_bit(shape, dtype):
    """The eval apply keeps the bias add and ``TorchBatchNorm``'s op order,
    so it is the eager composition's result exactly."""
    x, cb, scale, bias = _inputs(shape, dtype, seed=2)
    bn = _bn(shape[1], scale, bias, dtype).eval()
    y = T.tdnn_bn_act_eval_reference(x, cb, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                     EPS, SLOPE)
    with torch.no_grad():
        want = _eager(bn, x, cb)
    assert torch.equal(y, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_autograd_of_the_eager_ops_in_f64(shape):
    x, cb, scale, bias = _inputs(shape, torch.float64, seed=3)
    dy = torch.tensor(np.random.default_rng(4).standard_normal(shape))
    eager = _bn(shape[1], scale, bias, torch.float64)
    xe, cbe = x.clone().requires_grad_(True), cb.double().requires_grad_(True)
    want = torch.autograd.grad(_eager(eager, xe, cbe), (xe, eager.weight, eager.bias), dy)
    y, mean, var, inv = T.tdnn_bn_act_forward(x, cb, eager.weight, eager.bias, EPS, SLOPE)
    dx, dcb, dscale, dbias = T.tdnn_bn_act_backward(x, dy, cb, mean, inv, eager.weight,
                                                    eager.bias, SLOPE)
    for g, w, name in zip((dx, dscale, dbias), want, ("dx", "dscale", "dbias")):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= 1e-10, name
    # the conv bias's gradient sums dx: zero in exact arithmetic
    assert torch.allclose(dcb, dx.sum((0, 2)), rtol=0, atol=1e-12)
    assert float(dcb.abs().max()) <= 1e-10 * float(dx.abs().max()) * x.shape[0] * x.shape[2]


def test_the_train_op_passes_gradcheck():
    x, cb, scale, bias = _inputs((2, 3, 4), torch.float64, seed=5)
    args = [a.double().clone().requires_grad_(True) for a in (x, cb, scale, bias)]
    assert torch.autograd.gradcheck(
        lambda a, c, s, b: T.tdnn_bn_act_train(a, c, s, b, EPS, SLOPE)[0], args)


def test_the_train_op_returns_the_statistics_without_a_gradient():
    x, cb, scale, bias = _inputs((2, 4, 6), torch.float32, seed=6)
    x.requires_grad_(True)
    y, mean, var = T.tdnn_bn_act_train(x, cb, scale, bias, EPS, SLOPE)
    assert y.requires_grad and not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_follows_the_eager_recipe(shape):
    """A bf16 activation is biased and normalised as the eager bf16 ops do
    it (statistics in f32, each op rounded to bf16), and the backward rounds
    where their autograd rounds: the same result to a bf16 rounding."""
    x32, cb, scale, bias = _inputs(shape, torch.float32, seed=7)
    x = x32.bfloat16()
    dy = torch.tensor(np.random.default_rng(8).standard_normal(shape), dtype=torch.bfloat16)
    bn = _bn(shape[1], scale, bias)
    xe, cbe = x.clone().requires_grad_(True), cb.clone().requires_grad_(True)
    want = _eager(bn, xe, cbe)
    want_grads = torch.autograd.grad(want, (xe, cbe, bn.weight, bn.bias), dy)
    y, mean, var, inv = T.tdnn_bn_act_forward(x, cb, scale, bias, EPS, SLOPE)
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    assert _rel(y, want) <= 2 ** -7
    got = T.tdnn_bn_act_backward(x, dy, cb, mean, inv, scale, bias, SLOPE)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    for g, w, name in zip(got, want_grads, ("dx", "dconv_bias", "dscale", "dbias")):
        if name == "dconv_bias":   # rounding noise: its size, not its value
            assert abs(float(g.norm()) - float(w.norm())) <= 0.5 * float(w.norm()), name
        else:
            assert _rel(g, w) <= 2 ** -6, name
    bn.eval()
    with torch.no_grad():
        want_eval = _eager(bn, x, cb)
    assert torch.equal(T.tdnn_bn_act_eval(x, cb, bn.running_mean, bn.running_var, scale, bias,
                                          EPS, SLOPE), want_eval)


def test_bf16_keeps_the_recipes_rounding_noise_in_the_conv_bias_gradient():
    """The gradient that reaches a block's conv bias sums dx over the batch
    and time: zero in exact arithmetic, the recipe's rounding noise in bf16.
    T's backward keeps that noise at the eager ops' size (the exact dx
    rounded once to bf16 sums to several times less)."""
    shape = (16, 32, 300)
    x32, cb, scale, bias = _inputs(shape, torch.float32, seed=15)
    x = x32.bfloat16()
    dy = torch.tensor(np.random.default_rng(16).standard_normal(shape), dtype=torch.bfloat16)
    bn = _bn(shape[1], scale, bias)
    xe, cbe = x.clone().requires_grad_(True), cb.clone().requires_grad_(True)
    want_dx, want_dcb = torch.autograd.grad(_eager(bn, xe, cbe), (xe, cbe), dy)
    y, mean, var, inv = T.tdnn_bn_act_forward(x, cb, scale, bias, EPS, SLOPE)
    dx, dcb, _, _ = T.tdnn_bn_act_backward(x, dy, cb, mean, inv, scale, bias, SLOPE)
    noise = float(want_dcb.norm())
    assert abs(float(dcb.norm()) - noise) <= 0.05 * noise
    exact = T.tdnn_bn_act_backward(x.double(), dy.double(), cb.double(), mean.double(),
                                   inv.double(), scale.double(), bias.double(), SLOPE)[0]
    assert float(exact.sum((0, 2)).norm()) <= 1e-9 * noise
    assert float(exact.bfloat16().float().sum((0, 2)).norm()) <= 0.5 * noise


def test_the_wrappers_refuse_other_devices():
    x = torch.zeros((1, 2, 3), device="meta")
    p = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        T.tdnn_bn_act_forward(x, p, p, p)
    with pytest.raises(ValueError):
        T.tdnn_bn_act_eval(x, p, p, p, p, p)


# ---------------------------------------------------------------- the route
def _block(bn_first=True, dtype=torch.float32, c_in=6, c_out=8, seed=10):
    torch.manual_seed(seed)
    blk = TDNNBlock(c_in, c_out, [-1, 0, 1], bn_first).to(dtype)
    with torch.no_grad():
        blk.bn.weight.uniform_(0.5, 1.5)
        blk.bn.bias.normal_(0, 0.5)
        blk.bn.running_mean.normal_(0, 1)
        blk.bn.running_var.uniform_(0.5, 2.0)
    return blk


def _features(shape=(3, 11, 6), dtype=torch.float32, seed=11):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape), dtype=dtype)


def test_on_the_cpu_the_block_keeps_the_eager_ops(monkeypatch):
    """T runs on the card: a CPU activation never takes it."""
    calls = []
    monkeypatch.setattr(tdnn, "bn_leaky_ncw", lambda bn, y, cb: calls.append(bn) or None)
    blk = _block()
    blk(_features())
    with torch.no_grad():
        blk.eval()(_features())
    assert calls == []


def test_the_fused_block_keeps_the_layout_and_the_results(monkeypatch):
    """Train and eval: T's output has the eager block's shape and strides
    (the conv's ``(B, C, T)`` memory seen as ``(B, T, C)``), its values, its
    gradients and its running update; the conv runs without its bias, which
    T adds."""
    x = _features()
    eager = _block()
    xe = x.clone().requires_grad_(True)
    want = eager(xe)
    want_grads = torch.autograd.grad(want.square().sum(), [xe, *eager.parameters()])
    with _fused_on_cpu(monkeypatch) as calls:
        fused = _block()
        xf = x.clone().requires_grad_(True)
        got = fused(xf)
        got_grads = torch.autograd.grad(got.square().sum(), [xf, *fused.parameters()])
        assert calls == [True]
        with torch.no_grad():
            got_eval = fused.eval()(x)
        assert calls == [True, False]
    assert got.shape == want.shape and got.stride() == want.stride()
    assert got.stride() == (9 * 8, 1, 9)     # (B, T', C) over (B, C, T') memory
    assert _rel(got, want) <= 2e-6
    names = ["x"] + [n for n, _ in eager.named_parameters()]
    top = max(float(w.abs().max()) for w in want_grads)
    for name, g, w in zip(names, got_grads, want_grads):
        if name == "context_layer.bias":
            # zero in exact arithmetic (the BN takes the mean out): rounding noise
            assert float(g.abs().max()) <= 1e-5 * top and float(w.abs().max()) <= 1e-5 * top
        else:
            assert _rel(g, w) <= 1e-5, name
    for name in ("running_mean", "running_var"):
        assert _rel(getattr(fused.bn, name), getattr(eager.bn, name)) <= 2e-6
    with torch.no_grad():
        want_eval = eager.eval()(x)
    assert got_eval.stride() == want_eval.stride() and torch.equal(got_eval, want_eval)


@pytest.mark.parametrize("case", ["f64", "bn_first_false", "eval_with_grad"])
def test_the_route_keeps_the_eager_ops(case, monkeypatch):
    """f64, ``bn_first: false`` and an eval block whose output needs a
    gradient keep the eager ops wherever T could run."""
    with _fused_on_cpu(monkeypatch) as calls:
        if case == "f64":
            blk, x = _block(dtype=torch.float64), _features(dtype=torch.float64)
            blk(x)
            with torch.no_grad():
                blk.eval()(x)
        elif case == "bn_first_false":
            blk = _block(bn_first=False)
            blk(_features())
            with torch.no_grad():
                blk.eval()(_features())
        else:
            blk = _block().eval()
            out = blk(_features())
            assert out.requires_grad
        assert calls == []


def test_a_group_of_one_keeps_the_eager_ops(tmp_path, monkeypatch):
    """Inside a mesh's batch-statistics block the BN needs the group's
    statistics, which T does not take: the block keeps the eager ops."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh()
        assert mesh.data_group is not None
        with _fused_on_cpu(monkeypatch) as calls:
            blk = _block()
            with mesh.batch_stats():
                blk(_features())
            assert calls == []
            blk(_features())
            assert calls == [True]
    finally:
        dist.destroy_process_group()


def test_an_f32_network_step_through_t_matches_the_eager_network(monkeypatch):
    """A whole E-TDNN-shaped network, train step and extraction, through T
    (its plain versions) against the eager ops: the embedding, the loss's
    gradients and the running buffers."""
    x = _features((4, 30, 24), seed=12)

    def run(fused: bool):
        torch.manual_seed(13)
        net = SpeakerEmbNet(CONTEXTS, HIDDEN, input_dim=24, embedding_dim=16)
        with contextlib.ExitStack() as stack:
            if fused:
                calls = stack.enter_context(_fused_on_cpu(monkeypatch))
            emb = net(x)
            grads = torch.autograd.grad(emb.square().sum(), list(net.parameters()))
            with torch.no_grad():
                xv, _ = net.eval().extract_embedding(x)
            if fused:
                assert calls == [True] * len(CONTEXTS) + [False] * len(CONTEXTS)
        return emb, grads, xv, [b.bn.running_var.clone() for b in net.tdnn]

    got, want = run(True), run(False)
    assert _rel(got[0], want[0]) <= 1e-5
    top = max(float(w.abs().max()) for w in want[1])
    for g, w in zip(got[1], want[1]):
        # the conv biases' gradients are zero in exact arithmetic
        assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-3 * top)
    assert _rel(got[2], want[2]) <= 1e-5
    for g, w in zip(got[3], want[3]):
        assert _rel(g, w) <= 2e-6


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CARD_SHAPES = [(256, 512, 295), (256, 1500, 277), (3, 1500, 7), (5, 24, 1), (2, 8, 33)]


def _card_inputs(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, c, t = shape
    x = torch.randn(shape, device=dev, generator=gen) * (0.5 + torch.rand((1, c, 1), device=dev,
                                                                         generator=gen))
    cb = torch.randn(c, device=dev, generator=gen)
    scale = 0.5 + torch.rand(c, device=dev, generator=gen)
    bias = 0.5 * torch.randn(c, device=dev, generator=gen)
    dy = torch.randn(shape, device=dev, generator=gen)
    return x.to(dtype), cb, scale, bias, dy.to(dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_kernels_match_their_plain_versions_and_repeat_bit_for_bit(shape, dtype, card):
    x, cb, scale, bias, dy = _card_inputs(shape, dtype, card, seed=sum(shape))
    runs = [T.tdnn_bn_act_forward(x, cb, scale, bias, EPS, SLOPE) for _ in range(2)]
    y, mean, var, inv = runs[0]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    y_ref, mean_ref, var_ref = T.tdnn_bn_act_reference(x, cb, scale, bias, EPS, SLOPE)
    assert _rel(mean, mean_ref.double()) <= 1e-5 and _rel(var, var_ref) <= 1e-5
    atol = 2e-5 if dtype == torch.float32 else 1.6e-2
    assert float((y.float() - y_ref.float()).abs().max()) <= atol * float(y_ref.abs().max())
    back = [T.tdnn_bn_act_backward(x, dy, cb, mean, inv, scale, bias, SLOPE) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*back))
    dx, dcb, ds, db = back[0]
    dx_ref, dcb_ref, ds_ref, db_ref = T.tdnn_bn_act_backward_reference(x, dy, cb, mean, inv,
                                                                       scale, bias, SLOPE)
    sum_tol = 1e-4 if dtype == torch.float32 else 2 ** -7   # bf16: sums rounded to bf16
    assert _rel(ds, ds_ref) <= sum_tol and _rel(db, db_ref) <= sum_tol
    big = float(dx_ref.abs().max())
    assert float((dx.float() - dx_ref.float()).abs().max()) <= (
        1e-3 if dtype == torch.float32 else 1.7e-2) * big
    # the conv bias's gradient is a sum of dx, rounding noise around zero
    n = x.shape[0] * x.shape[2]
    assert float((dcb - dcb_ref).abs().max()) <= 1e-2 * big * n ** 0.5
    rm, rv = mean_ref.float() + 0.1, var_ref.float() * 1.1
    e = T.tdnn_bn_act_eval(x, cb, rm, rv, scale, bias, EPS, SLOPE)
    e_ref = T.tdnn_bn_act_eval_reference(x, cb, rm, rv, scale, bias, EPS, SLOPE)
    if dtype == torch.float32:
        assert torch.equal(e, e_ref)
    else:
        assert _rel(e, e_ref) <= 1.6e-2


@pytest.mark.card
def test_the_kernels_replay_bit_for_bit_in_a_cuda_graph(card):
    x, cb, scale, bias, dy = _card_inputs((64, 512, 295), torch.bfloat16, card, seed=14)
    x.requires_grad_(True)
    cb.requires_grad_(True)

    def step():
        y, mean, var = T.tdnn_bn_act_train(x, cb, scale, bias, EPS, SLOPE)
        dx, dcb = torch.autograd.grad(y, (x, cb), dy)
        return y.detach(), mean, var, dx, dcb, T.tdnn_bn_act_eval(
            x.detach(), cb.detach(), mean, var, scale, bias, EPS, SLOPE)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = [t.clone() for t in step()]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for _ in range(2):
        for o in out:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(out, want))


@pytest.mark.card
def test_the_wrappers_refuse_what_the_kernels_cannot_take(card):
    p = torch.ones(8, device=card)
    for x, error in ((torch.zeros((2, 8, 5), device=card, dtype=torch.float64), TypeError),
                     (torch.zeros((2, 5, 8), device=card).transpose(1, 2), ValueError),
                     (torch.zeros((2, 8), device=card), ValueError)):
        with pytest.raises(error):
            T.tdnn_bn_act_forward(x, p, p, p)
    with pytest.raises(ValueError):
        T.tdnn_bn_act_eval(torch.zeros((2, 8, 5), device=card), p, p, p, p.double(), p)
