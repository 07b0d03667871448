"""The port's video modules against the JAX package's, with weights carried
across by ``interop.from_jax.lipreading_state_dict``.

Small shapes (32×32 frames, one block per trunk stage, two TCN levels of
hidden 8), random BN parameters, running statistics and PReLU slopes. Train
mode checks outputs and the updated running statistics; eval mode checks the
outputs. Bars: 1e-4 in f32, 1e-9 in f64.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.interop.torch_export import export_lipreading_state_dict
from deeplip_tpu.models import lipreading as JL
from deeplip_tpu.models import norm as JN
from deeplip_tpu.models import resnet as JR
from deeplip_tpu.models import tcn as JT
from deeplip_tpu_torch.interop import from_jax
from deeplip_tpu_torch.interop.from_jax import lipreading_state_dict
from deeplip_tpu_torch.models import tcn as PT
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import BasicBlock
from deeplip_tpu_torch.ops.cuda import bn_prelu as K

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "float64": 1e-9}
DTYPES = ["float32", "float64"]
HW = 32


def _randomise(params, stats, rng):
    """BN scale/bias, running statistics and PReLU slopes away from their
    init values, in place."""
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "kernel" not in sub:
            c = sub["scale"].shape
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            stats[name]["mean"] = rng.normal(0, 0.5, c).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        elif "alpha" in sub:
            sub["alpha"] = rng.uniform(0.1, 0.4, sub["alpha"].shape).astype(np.float32)
        else:
            _randomise(sub, stats.setdefault(name, {}), rng)


def _init(module, x, seed, dtype):
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables.get("batch_stats", {}))
    _randomise(params, stats, np.random.default_rng(seed + 100))
    cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(dtype), t)  # noqa: E731
    return cast(params), cast(stats)


def _x64(dtype):
    return jax.enable_x64(dtype == "float64")


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL[dtype],
                               atol=TOL[dtype], err_msg=what)


def _stats_match(port_sd, jax_sd, dtype):
    n = 0
    for k, v in jax_sd.items():
        if k.endswith(("running_mean", "running_var")):
            _close(port_sd[k].numpy(), v, dtype, k)
            n += 1
    return n


# ---------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 3, 3, 8), (2, 3, 2, 2, 8), (3, 7, 8), (5, 8)])
def test_torch_batchnorm_train_and_eval(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 1.3 + 0.8).astype(dtype)
    with _x64(dtype):
        bn = JN.TorchBatchNorm()
        params = {"scale": rng.uniform(0.5, 1.5, 8).astype(dtype),
                  "bias": rng.normal(0, 0.2, 8).astype(dtype)}
        stats = {"mean": rng.normal(0, 0.5, 8).astype(dtype),
                 "var": rng.uniform(0.5, 2.0, 8).astype(dtype)}
        want, upd = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             use_running_average=False, mutable=["batch_stats"])
        want_eval = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             use_running_average=True)
    port = TorchBatchNorm(8).to(getattr(torch, dtype))
    port.load_state_dict({"weight": torch.tensor(params["scale"]),
                          "bias": torch.tensor(params["bias"]),
                          "running_mean": torch.tensor(stats["mean"]),
                          "running_var": torch.tensor(stats["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = port.train()(torch.tensor(x))
        _close(got.numpy(), want, dtype, "train y")
        _close(port.running_mean.numpy(), upd["batch_stats"]["mean"], dtype, "mean")
        _close(port.running_var.numpy(), upd["batch_stats"]["var"], dtype, "var")
        assert int(port.num_batches_tracked) == 1
        port.running_mean.copy_(torch.tensor(stats["mean"]))
        port.running_var.copy_(torch.tensor(stats["var"]))
        _close(port.eval()(torch.tensor(x)).numpy(), want_eval, dtype, "eval y")


# ---------------------------------------------------------------- ResNet block
def _block_state_dict(params, stats):
    out = {}
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        from_jax._conv(out, conv, params[conv])
        from_jax._bn(out, bn, params[bn], stats[bn])
    for relu in ("relu1", "relu2"):
        out[f"{relu}.weight"] = torch.tensor(params[relu]["alpha"])
    if "down_conv" in params:
        from_jax._conv(out, "downsample.0", params["down_conv"])
        from_jax._bn(out, "downsample.1", params["down_bn"], stats["down_bn"])
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin, planes, stride, avg_pool, hw", [
    (8, 8, 1, False, 6), (8, 16, 2, False, 7), (8, 16, 2, True, 7)])
def test_basic_block_matches(cin, planes, stride, avg_pool, hw, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, hw, hw, cin)).astype(dtype)
    with _x64(dtype):
        blk = JR.BasicBlock(planes=planes, stride=stride, avg_pool_downsample=avg_pool,
                            dtype=jnp.dtype(dtype))
        params, stats = _init(blk, x, 1, dtype)
        variables = {"params": params, "batch_stats": stats}
        want, upd = jax.jit(partial(blk.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        want_eval = jax.jit(partial(blk.apply, train=False))(variables, jnp.asarray(x))
    port = BasicBlock(cin, planes, stride, avg_pool_downsample=avg_pool).to(getattr(torch, dtype))
    port.load_state_dict(_block_state_dict(params, stats), strict=True)
    with torch.no_grad():
        _close(port.train()(torch.tensor(x)).numpy(), want, dtype, "train")
        want_sd = _block_state_dict(params, upd["batch_stats"])
        assert _stats_match(port.state_dict(), {k: v.numpy() for k, v in want_sd.items()},
                            dtype) == (6 if "down_conv" in params else 4)
        port.load_state_dict(_block_state_dict(params, stats), strict=True)
        _close(port.eval()(torch.tensor(x)).numpy(), want_eval, dtype, "eval")


# ---------------------------------------------------------------- TCNs
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel_sizes", [(3, 5, 7), (3,)])
def test_tcn_matches(kernel_sizes, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 16)).astype(dtype)
    chans = (12, 12)
    with _x64(dtype):
        if len(kernel_sizes) > 1:
            jnet = JT.MultibranchTemporalConvNet(chans, kernel_sizes, dropout=0.0)
            pnet = PT.MultibranchTemporalConvNet(16, chans, kernel_sizes, dropout=0.0)
            prefix = "tcn.mb_ms_tcn."
        else:
            jnet = JT.TemporalConvNet(chans, kernel_sizes[0], dropout=0.0)
            pnet = PT.TemporalConvNet(16, chans, kernel_sizes[0], dropout=0.0)
            prefix = "tcn.tcn_trunk."
        params, stats = _init(jnet, x, 2, dtype)
        variables = {"params": params, "batch_stats": stats}
        want, upd = jax.jit(partial(jnet.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        want_eval = jax.jit(partial(jnet.apply, train=False))(variables, jnp.asarray(x))

    def sd(s):
        out = {}
        from_jax._tcn(out, params, s)
        return {k.removeprefix(prefix): v for k, v in out.items()}

    pnet = pnet.to(getattr(torch, dtype))
    pnet.load_state_dict(sd(stats), strict=True)
    with torch.no_grad():
        _close(pnet.train()(torch.tensor(x)).numpy(), want, dtype, "train")
        assert _stats_match(pnet.state_dict(),
                            {k: v.numpy() for k, v in sd(upd["batch_stats"]).items()},
                            dtype) == 2 * (12 if len(kernel_sizes) > 1 else 4)
        pnet.load_state_dict(sd(stats), strict=True)
        _close(pnet.eval()(torch.tensor(x)).numpy(), want_eval, dtype, "eval")


# ---------------------------------------------------------------- Lipreading
@lru_cache(maxsize=None)
def _jax_init(kernel_sizes, seed=3):
    model = JL.Lipreading(num_classes=5, hidden_dim=8, tcn_kernel_sizes=kernel_sizes,
                          tcn_num_layers=2, tcn_dropout=0.0, trunk_layers=(1, 1, 1, 1))
    return _init(model, np.zeros((1, 2, HW, HW, 1)), seed, np.float32)


def _jax_lipreading(kernel_sizes, dtype):
    """The JAX model in ``dtype`` and one random f32 init cast to it."""
    params, stats = _jax_init(kernel_sizes)
    model = JL.Lipreading(num_classes=5, hidden_dim=8, tcn_kernel_sizes=kernel_sizes,
                          tcn_num_layers=2, tcn_dropout=0.0, trunk_layers=(1, 1, 1, 1),
                          dtype=jnp.dtype(dtype))
    cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(dtype), t)  # noqa: E731
    return model, cast(params), cast(stats)


def _port_lipreading(params, stats, kernel_sizes, dtype):
    net = Lipreading(num_classes=5, hidden_dim=8, tcn_kernel_sizes=kernel_sizes,
                     tcn_num_layers=2, tcn_dropout=0.0, trunk_layers=(1, 1, 1, 1))
    net = net.to(getattr(torch, dtype))
    net.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    return net


@pytest.mark.parametrize("kernel_sizes", [(3, 5, 7), (3,)])
def test_state_dict_equals_export_and_loads_strict(kernel_sizes):
    _, params, stats = _jax_lipreading(kernel_sizes, "float32")
    got = lipreading_state_dict(params, stats)
    want = export_lipreading_state_dict(params, stats)
    assert list(got) == list(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    net = Lipreading(num_classes=5, hidden_dim=8, tcn_kernel_sizes=kernel_sizes,
                     tcn_num_layers=2, trunk_layers=(1, 1, 1, 1))
    assert set(net.state_dict()) == set(want)
    net.load_state_dict(got, strict=True)


def test_shufflenet_trunk_is_refused():
    _, params, stats = _jax_lipreading((3,), "float32")
    params = dict(params, trunk={"stage2_unit0": {}})
    with pytest.raises(NotImplementedError, match="ShuffleNetV2"):
        lipreading_state_dict(params, stats)


@pytest.mark.parametrize("kernel_sizes, dtype", [
    ((3, 5, 7), "float32"), ((3, 5, 7), "float64"), ((3,), "float64")])
def test_lipreading_matches(kernel_sizes, dtype):
    model, params, stats = _jax_lipreading(kernel_sizes, dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, HW, HW, 1)).astype(dtype)
    lengths = np.array([5, 3, 4], np.int32)
    with _x64(dtype):
        variables = {"params": params, "batch_stats": stats}
        xj, lj = jnp.asarray(x), jnp.asarray(lengths)
        want_train, upd = jax.jit(partial(model.apply, train=True, mutable=["batch_stats"]))(
            variables, xj, lengths=lj)
        want_feats = jax.jit(partial(model.apply, method=model.frame_features))(variables, xj)
        want_logits = jax.jit(model.apply)(variables, xj, lengths=lj)
    net = _port_lipreading(params, stats, kernel_sizes, dtype)
    xt, lt = torch.tensor(x), torch.tensor(lengths)
    with torch.no_grad():
        _close(net.train()(xt, lengths=lt).numpy(), want_train, dtype, "train logits")
        want_sd = export_lipreading_state_dict(params, upd["batch_stats"])
        assert _stats_match(net.state_dict(), want_sd, dtype) > 20
        net.load_state_dict(lipreading_state_dict(params, stats), strict=True)
        net.eval()
        feats = net.frame_features(xt)
        _close(feats.numpy(), want_feats, dtype, "frame features")
        _close(net.classify(feats, lengths=lt).numpy(), want_logits, dtype, "classify")


def test_frontend_conv3d_matches_space_to_depth():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, HW, HW, 1)).astype(np.float32)
    conv = JL.FrontendConv3D(64)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(conv.apply)(variables, jnp.asarray(x))   # the TPU's s2d rewrite
    net = Lipreading(num_classes=5, hidden_dim=8, tcn_num_layers=1, trunk_layers=(1, 1, 1, 1))
    out = {}
    from_jax._conv(out, "weight", variables["params"])
    with torch.no_grad():
        net.frontend3D[0].weight.copy_(out["weight.weight"])
        got = net.frontend3D[0](torch.tensor(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("trunk_layers, sites", [((1, 1, 1, 1), 5), ((2, 2, 2, 2), 9)])
def test_fused_sites_run_in_train_mode_only(monkeypatch, trunk_layers, sites):
    calls = []
    fused = K.bn_prelu_train

    def counting(x, *args):
        calls.append(tuple(x.shape))
        return fused(x, *args)

    monkeypatch.setattr(K, "bn_prelu_train", counting)
    net = Lipreading(num_classes=4, hidden_dim=8, tcn_num_layers=1, tcn_dropout=0.0,
                     trunk_layers=trunk_layers)
    x = torch.zeros((1, 2, HW, HW, 1)).normal_(generator=torch.Generator().manual_seed(0))
    net.train()(x).sum().backward()
    assert len(calls) == sites
    assert calls[0] == (1, 2, HW // 2, HW // 2, 64)
    calls.clear()
    with torch.no_grad():
        net.eval()(x)
    assert calls == []
