"""The port's ShuffleNetV2 Lipreading and depthwise-separable TCN against the
JAX package's.

Small shapes: 32×32 frames (so the trunk's last stage is 1×1), the 0.5
width table (48/96/192, backend 1024), TCN hidden 8 over two levels. Weights
come from one JAX init with random BN parameters, running statistics and
PReLU slopes, carried across by ``interop.from_jax.lipreading_state_dict``:

- the trunk at every ``width_mult`` against an independent torch trunk in
  the reference's NCHW layout (``tests/test_shufflenet_import.py``), its
  state dict loaded strictly;
- the Lipreading, with and without ``tcn_dwpw``, single- and multi-branch:
  train-mode logits and every running statistic, eval-mode frame features
  and logits, bar 1e-4;
- 3 f64 ``VideoTrainer`` steps (ShuffleNet + ``dwpw``) against the JAX
  trainer: loss, parameters and BN statistics within 1e-9. The JAX cosine
  schedule evaluates in float32, so both trainers take its rates;
- under ``compute_dtype`` bf16 the frontend runs in bf16 and the trunk in
  f32, as the JAX model promotes it; the logits within 2e-2 of the JAX
  bf16 model's;
- the reference ``.pth``: a file from the JAX package's
  ``save_reference_video_checkpoint`` loads through the port and extracts
  the same frame features; the port's export reads back through the JAX
  ShuffleNet importer;
- ``cli/train_video.py`` end to end on a tiny corpus with the ShuffleNet
  and ``dwpw`` config, and its ``(1, T, 1024)`` feature files.
"""

import json
import os
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.interop.torch_export import (export_lipreading_state_dict,
                                              save_reference_video_checkpoint)
from deeplip_tpu.interop.torch_import import import_shufflenet_trunk_state_dict
from deeplip_tpu.models import lipreading as JL
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.video import VideoTrainer as JaxVideoTrainer
from deeplip_tpu_torch.cli import train_video as cli
from deeplip_tpu_torch.interop import torch_export as PE
from deeplip_tpu_torch.interop import torch_import as PI
from deeplip_tpu_torch.interop.from_jax import lipreading_state_dict
from deeplip_tpu_torch.models import shufflenetv2 as PS
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.ops.cuda import bn_prelu as K
from deeplip_tpu_torch.train.video import VideoTrainer
from tests.test_shufflenet_import import _torch_shufflenet_trunk

torch.set_num_threads(1)

HW, NC, WIDTH = 32, 5, 0.5
VARIANTS = [((3, 5, 7), False), ((3, 5, 7), True), ((3,), True)]


def _randomise(params, stats, rng):
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


def _jax_kw(kernel_sizes, dwpw):
    return dict(num_classes=NC, hidden_dim=8, backbone_type="shufflenet", width_mult=WIDTH,
                tcn_kernel_sizes=kernel_sizes, tcn_num_layers=2, tcn_dropout=0.0,
                tcn_dwpw=dwpw)


@lru_cache(maxsize=None)
def _jax_init(kernel_sizes, dwpw, seed=3):
    model = JL.Lipreading(**_jax_kw(kernel_sizes, dwpw))
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 2, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    _randomise(params, stats, np.random.default_rng(seed + 100))
    return params, stats


def _jax_model(kernel_sizes, dwpw, dtype="float32"):
    params, stats = _jax_init(kernel_sizes, dwpw)
    cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(dtype), t)  # noqa: E731
    model = JL.Lipreading(**_jax_kw(kernel_sizes, dwpw), dtype=jnp.dtype(dtype))
    return model, cast(params), cast(stats)


def _port_model(params, stats, kernel_sizes, dwpw):
    net = Lipreading(num_classes=NC, hidden_dim=8, backbone_type="shufflenet",
                     width_mult=WIDTH, tcn_kernel_sizes=kernel_sizes, tcn_num_layers=2,
                     tcn_dropout=0.0, tcn_dwpw=dwpw)
    net.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    return net


def test_channel_shuffle_is_the_nchw_shuffle():
    x = torch.arange(2 * 3 * 3 * 12, dtype=torch.float32).reshape(2, 3, 3, 12)
    nchw = x.movedim(-1, 1)
    b, c, h, w = nchw.shape
    want = nchw.view(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)
    assert torch.equal(PS.channel_shuffle(x), want.movedim(1, -1))


@pytest.mark.parametrize("width_mult", [0.5, 1.0, 1.5, 2.0])
def test_trunk_matches_an_independent_reference_trunk(width_mult):
    chans = PS.STAGE_CHANNELS[width_mult]
    torch.manual_seed(0)
    ref = _torch_shufflenet_trunk(torch, chans)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.2, generator=g)
                m.running_mean.normal_(0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    trunk = PS.ShuffleNetV2Trunk(width_mult).eval()
    assert trunk.backend_out == chans[-1]
    trunk.load_state_dict(ref.trunk.state_dict(), strict=True)
    x = torch.randn(2, 24, 16, 16, generator=g)
    with torch.no_grad():
        want = ref(x)
        got = trunk(x.movedim(1, -1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel_sizes, dwpw", VARIANTS)
def test_state_dict_carries_and_loads_strict(kernel_sizes, dwpw):
    _, params, stats = _jax_model(kernel_sizes, dwpw)
    got = lipreading_state_dict(params, stats)
    net = _port_model(params, stats, kernel_sizes, dwpw)
    assert set(net.state_dict()) == set(got)
    assert net.frontend3D[0].weight.shape[0] == 24 and net.backend_out == 1024
    if not dwpw:
        # the reference layout, which the JAX exporter has for this model
        want = export_lipreading_state_dict(params, stats)
        assert list(got) == list(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    else:
        assert any(".dw_conv." in k for k in got) and not any(".conv.weight" in k for k in got
                                                              if "cbcr" in k)


@pytest.mark.parametrize("kernel_sizes, dwpw", VARIANTS)
def test_lipreading_matches_jax(kernel_sizes, dwpw):
    model, params, stats = _jax_model(kernel_sizes, dwpw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, HW, HW, 1)).astype(np.float32)
    lengths = np.array([5, 3, 4], np.int32)
    variables = {"params": params, "batch_stats": stats}
    xj, lj = jnp.asarray(x), jnp.asarray(lengths)
    want_train, upd = jax.jit(partial(model.apply, train=True, mutable=["batch_stats"]))(
        variables, xj, lengths=lj)
    want_feats = jax.jit(partial(model.apply, method=model.frame_features))(variables, xj)
    want_logits = jax.jit(model.apply)(variables, xj, lengths=lj)
    net = _port_model(params, stats, kernel_sizes, dwpw)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.no_grad():
        got = net.train()(xt, lengths=lt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_train), atol=1e-4, rtol=1e-4)
        want_sd = lipreading_state_dict(params, jax.tree_util.tree_map(np.asarray,
                                                                       upd["batch_stats"]))
        n = 0
        for k, v in want_sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(net.state_dict()[k].numpy(), v.numpy(), atol=1e-4,
                                           rtol=1e-4, err_msg=k)
                n += 1
        assert n > 100   # the frontend, every trunk BN and the TCN's
        net.load_state_dict(lipreading_state_dict(params, stats), strict=True)
        net.eval()
        feats = net.frame_features(xt)
        assert feats.shape == (3, 5, 1024)
        np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(net.classify(feats, lengths=lt).numpy(),
                                   np.asarray(want_logits), atol=1e-4, rtol=1e-4)


def test_fused_site_is_the_frontend_alone(monkeypatch):
    """The 24-channel frontend BN+PReLU is the one fused site in train mode;
    the trunk's BN+ReLU pairs are plain."""
    calls = []
    fused = K.bn_prelu_train

    def counting(x, *args):
        calls.append(tuple(x.shape))
        return fused(x, *args)

    monkeypatch.setattr(K, "bn_prelu_train", counting)
    _, params, stats = _jax_model((3,), True)
    net = _port_model(params, stats, (3,), True)
    x = torch.zeros((2, 3, HW, HW, 1)).normal_(generator=torch.Generator().manual_seed(0))
    net.train()(x).sum().backward()
    assert calls == [(2, 3, HW // 2, HW // 2, 24)]
    calls.clear()
    with torch.no_grad():
        net.eval()(x)
    assert calls == []


def _pair(tmp_path, cfg, dtype):
    small = dict(crop_size=(HW, HW), hidden_dim=8)
    jtr = JaxVideoTrainer(JaxConfig(cfg), NC, exp_root=str(tmp_path / "jax"), **small)
    if dtype == "float64":
        jtr.model = jtr.model.clone(dtype=jnp.float64)
        jtr.train_model = jtr.model
    variables = jax.jit(jtr.model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 2, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    _randomise(params, stats, np.random.default_rng(7))
    cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), t)  # noqa: E731
    params, stats = cast(params), cast(stats)
    state = JState.TrainState(params=params, batch_stats=stats,
                              opt_state=jtr.tx.init(params), step=0)
    ptr = VideoTrainer(cfg, NC, device="cpu", exp_root=str(tmp_path / "port"), **small)
    ptr.model.to(getattr(torch, dtype))
    ptr.model.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    return jtr, state, ptr


CFG = {"backbone_type": "shufflenet", "width_mult": WIDTH, "relu_type": "prelu",
       "tcn_kernel_size": [3, 5, 7], "tcn_num_layers": 2, "tcn_dropout": 0.0,
       "tcn_dwpw": True, "tcn_width_mult": 1}


def test_three_f64_steps_match_jax(tmp_path):
    steps, tol, bs, t = 3, 1e-9, 3, 5
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((steps, bs, t, HW, HW, 1))
    labels = rng.integers(0, NC, (steps, bs)).astype(np.int64)
    lengths = np.array([t, 0, t - 2], np.int32)   # a length-0 row is left out of the loss
    with jax.enable_x64(True):
        jtr, state, ptr = _pair(tmp_path, CFG, "float64")
        # the JAX cosine schedule evaluates in float32 (the port's in
        # float64, 5e-8 apart): both steps take the JAX rate here
        ptr.schedule = lambda step: float(jtr.schedule(step))
        for k in range(steps):
            state, jm = jtr._train_step_frames(state, jnp.asarray(frames[k]),
                                               jnp.asarray(lengths), jnp.asarray(labels[k]),
                                               jax.random.PRNGKey(k))
            pm = ptr.train_step_frames(torch.tensor(frames[k]), torch.tensor(lengths),
                                       torch.tensor(labels[k]))
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=tol,
                                       atol=tol, err_msg=f"loss, step {k}")
        want = lipreading_state_dict(jax.tree_util.tree_map(np.asarray, state.params),
                                     jax.tree_util.tree_map(np.asarray, state.batch_stats))
        got = ptr.model.state_dict()
        assert set(got) == set(want)
        for name, v in want.items():
            if name.endswith("num_batches_tracked"):
                assert int(got[name]) == steps, name
                continue
            np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=tol, rtol=tol,
                                       err_msg=name)


def test_bf16_runs_the_frontend_in_bf16_and_the_trunk_in_f32():
    """The types in a bf16 train step, and bf16 frame features against the
    JAX bf16 model's in eval mode: in train mode, BN statistics over this
    test's 8 frames magnify the two packages' different bf16 roundings of
    the frontend past any fixed bar."""
    _, params, stats = _jax_model((3, 5, 7), True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, HW, HW, 1)).astype(np.float32)
    lengths = np.array([4, 3], np.int32)
    jmodel = JL.Lipreading(**_jax_kw((3, 5, 7), True), dtype=jnp.bfloat16)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                        method=jmodel.frame_features)
    net = _port_model(params, stats, (3, 5, 7), True).train()
    seen = {}

    def dtype_of(name):
        def hook(mod, args, out):
            seen[name] = (args[0].dtype, out.dtype)
        return hook

    hooks = [net.trunk.register_forward_hook(dtype_of("trunk")),
             net.trunk[0][0].register_forward_hook(dtype_of("unit"))]
    with torch.no_grad():
        logits = net(torch.from_numpy(x), lengths=torch.from_numpy(lengths),
                     compute_dtype=torch.bfloat16)
    for h in hooks:
        h.remove()
    assert seen == {"trunk": (torch.bfloat16, torch.float32),
                    "unit": (torch.float32, torch.float32)}
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    net.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    with torch.no_grad():
        got = net.eval().frame_features(torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_reference_pth_round_trips(tmp_path):
    model, params, stats = _jax_model((3,), False)
    path = str(tmp_path / "5.pt")
    save_reference_video_checkpoint(path, params, stats, data_parallel_prefix=True)
    net = Lipreading(num_classes=NC, hidden_dim=8, backbone_type="shufflenet",
                     width_mult=WIDTH, tcn_kernel_sizes=(3,), tcn_num_layers=2,
                     tcn_dropout=0.0)
    net.load_state_dict(PI.load_reference_video_checkpoint(path, net.state_dict()),
                        strict=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, HW, HW, 1)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                       method=model.frame_features)
    with torch.no_grad():
        got = net.eval().frame_features(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the port's export, the dwpw model's too, reads back through the JAX importer
    _, params, stats = _jax_model((3, 5, 7), True)
    out = str(tmp_path / "port.pt")
    PE.save_reference_video_checkpoint(out, lipreading_state_dict(params, stats))
    jp, js = import_shufflenet_trunk_state_dict(torch.load(out, weights_only=True))
    leaves = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    for want, got in ((params["trunk"], jp), (stats["trunk"], js)):
        assert leaves(got).keys() == leaves(want).keys()
        for path, v in leaves(want).items():
            np.testing.assert_array_equal(leaves(got)[path], v, err_msg=str(path))


def test_video_cli_trains_and_extracts_the_shufflenet_config(tmp_path):
    rng = np.random.default_rng(0)
    for spk in range(2):
        os.makedirs(tmp_path / "clips" / f"s{spk}")
        for c in range(2):
            np.savez(str(tmp_path / "clips" / f"s{spk}" / f"c{c}.npz"),
                     data=rng.integers(0, 255, (4 + c, 96, 96)).astype(np.uint8))
    cfg = dict(CFG, width_mult=0.5, tcn_num_layers=1)
    path = tmp_path / "video.json"
    path.write_text(json.dumps(cfg))
    common = ["--config-path", str(path), "--data-dir", str(tmp_path / "clips"),
              "--batch-size", "4", "--device", "cpu", "--workers", "1"]
    trainer, out = cli.main(common + ["--epochs", "1", "--compute-dtype", "bf16",
                                      "--exp-root", str(tmp_path / "exp"), "--log-time", "t"])
    assert trainer.model.backend_out == 1024 and trainer.model.frontend3D[1].weight.numel() == 24
    assert len(out["losses"]) == trainer.step and np.all(np.isfinite(out["losses"]))
    emb = tmp_path / "emb"
    _, ext = cli.main(common + ["--extract-feats", "--model-path",
                                str(tmp_path / "exp" / "t" / "net_1"),
                                "--mouth-embedding-out-path", str(emb)])
    arr = np.load(str(emb / "s1" / "c1.npz"))["data"]
    assert arr.shape == (1, 5, 1024) and arr.dtype == np.float32
    np.testing.assert_array_equal(arr[0], ext["features"]["s1/c1"])
