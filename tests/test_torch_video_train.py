"""The port's video training step against the JAX package's ``VideoTrainer``.

Both trainers start from the same weights (a JAX init with random BN and
PReLU parameters, carried across by ``interop.from_jax``) and take the same
steps from the same pre-transformed frames, with TCN dropout 0: the
reference's train-step parity harness (``scripts/parity_check.py
--train-parity-video``) with the port in place of the torch mirror. The
JAX trainer runs on the 8-virtual-CPU mesh of ``tests/conftest.py``; its BN
statistics there are global, the same numbers as the port's single-device
ones. Also: the cosine schedule, Adam, the loss, checkpoints and metrics.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.interop.torch_export import export_lipreading_state_dict
from deeplip_tpu.losses.softmax import softmax_cross_entropy as jax_ce
from deeplip_tpu.train import schedules as JS
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.video import VideoTrainer as JaxVideoTrainer
from deeplip_tpu_torch.interop.from_jax import lipreading_state_dict
from deeplip_tpu_torch.losses.softmax import softmax_cross_entropy
from deeplip_tpu_torch.train import checkpoint as ckpt
from deeplip_tpu_torch.train.audio import fp32_math
from deeplip_tpu_torch.train.metrics import NanGuard, StepLogger
from deeplip_tpu_torch.train.schedules import cosine_annealing_schedule
from deeplip_tpu_torch.train.state import torch_adam
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(1)

CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3, 5, 7],
       "tcn_num_layers": 2, "tcn_dropout": 0.0, "tcn_dwpw": False, "tcn_width_mult": 1,
       "width_mult": 1.0}
HW, T, BS, NC = 32, 6, 3, 5
SMALL = dict(crop_size=(HW, HW), hidden_dim=8, trunk_layers=(1, 1, 1, 1))


def _randomise(params, rng):
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "kernel" not in sub:
            sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, sub["bias"].shape).astype(np.float32)
        elif "alpha" in sub:
            sub["alpha"] = rng.uniform(0.1, 0.4, sub["alpha"].shape).astype(np.float32)
        else:
            _randomise(sub, rng)


def _pair(dtype, tmp_path):
    """The JAX trainer with its state and the port's trainer, same weights."""
    jtr = JaxVideoTrainer(JaxConfig(CFG), NC, exp_root=str(tmp_path / "jax"), **SMALL)
    if dtype == "float64":
        jtr.model = jtr.model.clone(dtype=jnp.float64)
        jtr.train_model = jtr.model
    variables = jax.jit(jtr.model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 2, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    _randomise(params, np.random.default_rng(7))
    cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), t)  # noqa: E731
    params, stats = cast(params), cast(variables["batch_stats"])
    state = JState.TrainState(params=params, batch_stats=stats,
                              opt_state=jtr.tx.init(params), step=0)
    ptr = VideoTrainer(CFG, NC, device="cpu", exp_root=str(tmp_path / "port"), **SMALL)
    ptr.model.to(getattr(torch, dtype))
    ptr.model.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    return jtr, state, ptr


def _batches(dtype, steps, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((steps, BS, T, HW, HW, 1)).astype(dtype)
    labels = rng.integers(0, NC, (steps, BS)).astype(np.int64)
    lengths = np.array([T, 0, T - 2], np.int32)  # a length-0 row is left out of the loss
    return frames, labels, lengths


def _compare_states(jstate, ptr, tol, steps):
    want = export_lipreading_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                                        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = ptr.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        if k.endswith("num_batches_tracked"):
            assert int(g) == steps, k
            continue
        np.testing.assert_allclose(g, v, atol=tol, rtol=tol, err_msg=k)


def test_three_f64_steps_match_jax(tmp_path):
    steps, tol = 3, 1e-7
    frames, labels, lengths = _batches("float64", steps)
    with jax.enable_x64(True):
        jtr, state, ptr = _pair("float64", tmp_path)
        for k in range(steps):
            state, jm = jtr._train_step_frames(state, jnp.asarray(frames[k]),
                                               jnp.asarray(lengths), jnp.asarray(labels[k]),
                                               jax.random.PRNGKey(k))
            pm = ptr.train_step_frames(torch.tensor(frames[k]), torch.tensor(lengths),
                                       torch.tensor(labels[k]))
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=tol,
                                       atol=tol, err_msg=f"loss, step {k}")
            assert float(pm["acc"]) == pytest.approx(float(jm["acc"]))
        assert ptr.step == steps
        _compare_states(state, ptr, tol, steps)


def test_f32_step_matches_jax(tmp_path):
    """One f32 step: loss, updated running statistics and gradients within
    1e-4, and the parameters within 1e-4 wherever the gradient is above f32
    noise. A gradient's bar is 1e-4 of its tensor's largest, and at least
    1e-6: the biases of the convolutions that feed a train-mode BN have a
    gradient of exactly zero in exact arithmetic, so theirs is rounding noise
    (~1e-8) in either framework. Adam's first step is ``lr·g/(|g|+eps)``,
    about ``lr·sign(g)``, so where the gradient is noise the step is
    arbitrary too."""
    frames, labels, lengths = _batches("float32", 1)
    jtr, state, ptr = _pair("float32", tmp_path)
    x, lens, labs = jnp.asarray(frames[0]), jnp.asarray(lengths), jnp.asarray(labels[0])
    valid = (lens > 0).astype(jnp.float32)

    def loss_fn(params):
        logits, upd = jtr.train_model.apply(
            {"params": params, "batch_stats": state.batch_stats}, x,
            lengths=jnp.maximum(lens, 1), train=True, mutable=["batch_stats"])
        loss = jnp.sum(jax_ce(logits, labs, reduction="none") * valid) / jnp.sum(valid)
        return loss, upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    updates, _ = jtr.tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    pm = ptr.train_step_frames(torch.tensor(frames[0]), torch.tensor(lengths),
                               torch.tensor(labels[0]))
    assert float(pm["loss"]) == pytest.approx(float(loss), rel=1e-4, abs=1e-4)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want_g = export_lipreading_state_dict(np_tree(grads), np_tree(stats))
    want = export_lipreading_state_dict(np_tree(params), np_tree(stats))
    got = ptr.model.state_dict()
    for name, p in ptr.model.named_parameters():
        g, wg = p.grad.numpy(), want_g[name]
        bar = max(1e-4 * float(np.abs(wg).max()), 1e-6)
        np.testing.assert_allclose(g, wg, atol=bar, rtol=0, err_msg=f"grad {name}")
        live = np.abs(wg) > bar
        np.testing.assert_allclose(got[name].numpy()[live], want[name][live], atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=1e-4, err_msg=k)


def test_cosine_schedule_matches_jax():
    want = JS.cosine_annealing_schedule(3e-4, 5)
    got = cosine_annealing_schedule(3e-4, 5)
    for step in range(13):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12)


def test_adam_matches_optax_torch_adam():
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    sched_j, sched_p = JS.cosine_annealing_schedule(3e-4, 5), cosine_annealing_schedule(3e-4, 5)
    tx = JState.torch_adam(sched_j, weight_decay=1e-4)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(pj)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = torch_adam(params.values(), 3e-4, weight_decay=1e-4)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        for group in opt.param_groups:
            group["lr"] = sched_p(step)
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), atol=1e-7, rtol=1e-6)


def test_softmax_cross_entropy_matches():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 6)
    got = softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels), reduction="none")
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    mean = softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels))
    ref = torch.nn.functional.cross_entropy(torch.tensor(logits), torch.tensor(labels))
    assert float(mean) == pytest.approx(float(ref), rel=1e-6)


def test_checkpoint_round_trip(tmp_path):
    tr = VideoTrainer(CFG, NC, device="cpu", exp_root=str(tmp_path), log_time="run", **SMALL)
    assert ckpt.latest_checkpoint(tr.exp_dir) is None
    x = torch.zeros((2, T, HW, HW, 1)).normal_(generator=torch.Generator().manual_seed(0))
    tr.train_step_frames(x, torch.tensor([T, T - 1]), torch.tensor([0, 1]))
    tr.current_epoch = 1
    path = tr.save()
    tr.save(3)
    assert os.path.basename(path) == "net_1" and ckpt.latest_checkpoint(tr.exp_dir) == 3
    tree = torch.load(path, weights_only=True)
    assert set(tree) == {"epoch", "state_dict"} and tree["epoch"] == 1
    other = VideoTrainer(CFG, NC, device="cpu", exp_root=str(tmp_path), log_time="run",
                         seed=1, **SMALL)
    other.load(os.path.join(tr.exp_dir, "net_1"))
    assert other.current_epoch == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_step_logger_and_nan_guard(tmp_path, capsys):
    log = StepLogger(str(tmp_path), print_every=10, prefix="video")
    log.log(5, examples=4, loss=1.5, lr=3e-4)
    log.log(15, examples=4, loss=1.25)
    log.close()
    records = [json.loads(line) for line in open(tmp_path / "video_metrics.jsonl")]
    assert [r["step"] for r in records] == [5, 15] and records[1]["loss"] == 1.25
    assert "examples_per_sec" in records[1]
    assert capsys.readouterr().out.count("[video]") == 2
    guard = NanGuard(patience=2)
    assert guard.check(1.0) and not guard.check(float("nan"))
    with pytest.raises(FloatingPointError):
        guard.check(float("inf"))


def test_fp32_math_keeps_the_callers_cudnn_settings():
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=True):
        with fp32_math():
            assert cudnn.deterministic and not cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert cudnn.deterministic and cudnn.allow_tf32
