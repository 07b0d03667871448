"""bf16 video training and the video CLI against the JAX package.

- The bf16 Lipreading forward (``compute_dtype=torch.bfloat16``) against
  the JAX ``Lipreading.clone(dtype=bfloat16)`` on the same weights, and
  each stage's type audited (frontend, max-pool and trunk blocks bf16;
  every BN's batch statistics f32; the trunk's spatial mean, the TCN and
  the logits f32). In eval mode frame features and logits lie within 2e-2
  of their norm of the JAX clone's. In train mode the port's fused
  BN+PReLU rounds to bf16 once where the JAX clone rounds after every op,
  so the two bf16 forwards are independent roundings of the f32 one (2.5e-2
  apart on these weights, the JAX clone's 2.4e-2 from the f32 forward): the
  port's is held to the JAX f32 forward within 2e-2.
- 2 bf16 ``VideoTrainer`` steps against the JAX bf16 trainer's
  ``_train_step_frames``: loss within 2e-2 relative.
- The trainer's ``compute_dtype`` check, and a bf16 group of two steps
  (``steps_per_dispatch=2``) equal to two single steps.
- ``cli/train_video.py``: train (bf16) and ``--extract-feats`` end to end on
  the CPU; extraction from a checkpoint the JAX CLI trained (carried by
  ``interop.from_jax``) writes the JAX CLI's npz tree within 1e-4.
- ``data/video_io.py`` against the JAX module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.cli import train_video as jax_cli
from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.data import video_io as jax_video_io
from deeplip_tpu.data.synthetic import make_video_corpus
from deeplip_tpu.models.lipreading import Lipreading as JaxLipreading
from deeplip_tpu.train import checkpoint as jax_ckpt
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.video import VideoTrainer as JaxVideoTrainer
from deeplip_tpu_torch.cli import train_video as cli
from deeplip_tpu_torch.data import video_io
from deeplip_tpu_torch.interop.from_jax import lipreading_state_dict
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import BasicBlock
from deeplip_tpu_torch.ops import video as V
from deeplip_tpu_torch.ops.cuda import bn_prelu
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(1)

CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3, 5],
       "tcn_num_layers": 1, "tcn_dropout": 0.0, "tcn_dwpw": False, "tcn_width_mult": 1,
       "width_mult": 1.0}
HW, T, BS, NC = 24, 5, 3, 4
SMALL = dict(crop_size=(HW, HW), hidden_dim=8, trunk_layers=(1, 1, 1, 1))


def _randomise(params, rng):
    for sub in params.values():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "kernel" not in sub:
            sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, sub["bias"].shape).astype(np.float32)
        elif "alpha" in sub:
            sub["alpha"] = rng.uniform(0.1, 0.4, sub["alpha"].shape).astype(np.float32)
        else:
            _randomise(sub, rng)


def _weights(jmodel):
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 2, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    _randomise(params, np.random.default_rng(7))
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(
        np.float32), stats)
    return params, stats


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BS, T, HW, HW, 1)).astype(np.float32),
            np.array([T, T - 2, T], np.int32), rng.integers(0, NC, BS).astype(np.int64))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("train", [False, True])
def test_bf16_lipreading_matches_the_jax_bf16_clone(train):
    jm = JaxLipreading.from_config(JaxConfig(CFG), NC).clone(hidden_dim=8,
                                                             trunk_layers=(1, 1, 1, 1))
    params, stats = _weights(jm)
    jb = jm.clone(dtype=jnp.bfloat16)
    pm = Lipreading.from_config(CFG, NC, hidden_dim=8, trunk_layers=(1, 1, 1, 1))
    pm.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    pm.train(train)
    x, lengths, _ = _frames()
    variables = {"params": params, "batch_stats": stats}
    kw = dict(mutable=["batch_stats"]) if train else {}

    def run(m):
        feats = m.apply(variables, jnp.asarray(x), train=train, method=m.frame_features, **kw)
        logits = m.apply(variables, jnp.asarray(x), lengths=jnp.asarray(lengths), train=train,
                         **kw)
        return (feats[0], logits[0]) if train else (feats, logits)

    jfeats, jlogits = run(jb)
    f32_feats, f32_logits = run(jm)

    seen, hooks = {}, []

    def record(name):
        def hook(mod, args, out):
            seen.setdefault(name, set()).add(out.dtype)
        return hook

    for name, mod in pm.named_modules():
        if isinstance(mod, BasicBlock) or name in ("frontend3D.0", "tcn"):
            hooks.append(mod.register_forward_hook(record(name)))
    stat_types = set()
    update = TorchBatchNorm.update_running

    def audited(self, mean, var, n):
        stat_types.update({mean.dtype, var.dtype})
        return update(self, mean, var, n)

    fused = []
    inner = bn_prelu.bn_prelu_train

    def fused_call(x, *args):
        y, mean, var = inner(x, *args)
        fused.append((x.dtype, y.dtype, mean.dtype))
        return y, mean, var

    TorchBatchNorm.update_running = audited
    bn_prelu.bn_prelu_train = fused_call
    try:
        with torch.no_grad():
            feats = pm.frame_features(torch.tensor(x), torch.bfloat16)
            logits = pm(torch.tensor(x), torch.tensor(lengths), compute_dtype=torch.bfloat16)
            tcn_out = pm.tcn.temporal(feats)
    finally:
        TorchBatchNorm.update_running = update
        bn_prelu.bn_prelu_train = inner
        for h in hooks:
            h.remove()
    # the JAX bf16 clone's own types: frame features and logits in f32
    assert jfeats.dtype == jnp.float32 and jlogits.dtype == jnp.float32
    assert feats.dtype == logits.dtype == tcn_out.dtype == torch.float32
    blocks = {n: t for n, t in seen.items() if n not in ("tcn",)}
    assert blocks and all(t == {torch.bfloat16} for t in blocks.values()), seen
    if train:
        # K3's (here its plain version's) statistics and every BN's are f32
        assert stat_types == {torch.float32}
        assert len(fused) == 2 * 5 and all(
            (xd, yd, md) == (torch.bfloat16, torch.bfloat16, torch.float32)
            for xd, yd, md in fused), fused
    want_feats, want_logits = (f32_feats, f32_logits) if train else (jfeats, jlogits)
    assert _rel(feats, want_feats) <= 2e-2
    assert _rel(logits, want_logits) <= 2e-2


def _trainer_pair(tmp_path, compute_dtype):
    jtr = JaxVideoTrainer(JaxConfig(CFG), NC, exp_root=str(tmp_path / "jax"),
                          compute_dtype=compute_dtype, **SMALL)
    params, stats = _weights(jtr.model)
    state = JState.TrainState(params=params, batch_stats=stats,
                              opt_state=jtr.tx.init(params), step=0)
    ptr = VideoTrainer(CFG, NC, device="cpu", exp_root=str(tmp_path / "port"),
                       compute_dtype=compute_dtype, **SMALL)
    ptr.model.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    return jtr, state, ptr


def test_two_bf16_steps_match_the_jax_bf16_trainer(tmp_path):
    jtr, state, ptr = _trainer_pair(tmp_path, "bf16")
    assert ptr.compute_dtype is torch.bfloat16
    losses = []
    for k in range(2):
        x, lengths, labels = _frames(seed=k)
        state, jm = jtr._train_step_frames(state, jnp.asarray(x), jnp.asarray(lengths),
                                           jnp.asarray(labels), jax.random.PRNGKey(k))
        pm = ptr.train_step_frames(torch.tensor(x), torch.tensor(lengths), torch.tensor(labels))
        losses.append(float(pm["loss"]))
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2), k
    # a bf16 step, not the f32 one
    _, _, f32 = _trainer_pair(tmp_path, "float32")
    x, lengths, labels = _frames(seed=0)
    assert float(f32.train_step_frames(torch.tensor(x), torch.tensor(lengths),
                                       torch.tensor(labels))["loss"]) != losses[0]


def test_video_trainer_checks_its_dispatch_options():
    with pytest.raises(ValueError, match="bf16 or float32"):
        VideoTrainer(CFG, NC, device="cpu", compute_dtype="fp16", **SMALL)
    assert VideoTrainer(CFG, NC, device="cpu", compute_dtype="bfloat16",
                        **SMALL).compute_dtype is torch.bfloat16
    # grouped dispatch: a bf16 group of 2 steps equals 2 single bf16 steps
    # with the same draws (on the CPU a group runs its steps eagerly)
    single, grouped = (VideoTrainer(CFG, NC, device="cpu", compute_dtype="bf16",
                                    steps_per_dispatch=k, **SMALL) for k in (1, 2))
    assert (single.steps_per_dispatch, grouped.steps_per_dispatch) == (1, 2)
    rng = np.random.default_rng(5)
    clips = torch.from_numpy(rng.integers(0, 256, (2, BS, T, HW + 4, HW + 4), np.uint8))
    lengths = torch.full((2, BS), T)
    labels = torch.from_numpy(rng.integers(0, NC, (2, BS)))
    gen = torch.Generator().manual_seed(3)
    losses = [float(single.train_step(clips[i], lengths[i], labels[i], gen)["loss"])
              for i in range(2)]
    gen = torch.Generator().manual_seed(3)
    draws = [(*V.crop_offsets(clips[i], SMALL["crop_size"], gen), V.flip_flags(BS, gen))
             for i in range(2)]
    out = grouped.train_group(clips, lengths, labels, {
        n: torch.stack(d) for n, d in zip(("dh", "dw", "flip"), zip(*draws))})
    assert out["loss"].tolist() == losses and grouped.step == 2
    for a, b in zip(single.model.state_dict().values(), grouped.model.state_dict().values()):
        assert torch.equal(a, b)


def _npz_tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = np.load(os.path.join(d, f))["data"]
    return out


def test_video_cli_trains_and_extracts_like_the_jax_cli(tmp_path):
    data = str(tmp_path / "clips")
    make_video_corpus(data, n_spk=3, clips_per_spk=2, t=6, size=96)
    cfg_path = str(tmp_path / "video.json")
    with open(cfg_path, "w") as fh:
        fh.write('{"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3], '
                 '"tcn_num_layers": 1, "tcn_dropout": 0.0}')
    common = ["--config-path", cfg_path, "--data-dir", data, "--batch-size", "4",
              "--workers", "1"]

    # the port's CLI: one bf16 epoch, then extraction from its checkpoint
    trainer, out = cli.main(common + ["--epochs", "1", "--compute-dtype", "bf16",
                                      "--exp-root", str(tmp_path / "pexp"), "--log-time", "t",
                                      "--device", "cpu"])
    assert trainer.compute_dtype is torch.bfloat16 and trainer.current_epoch == 1
    assert len(out["losses"]) == trainer.step >= 2 and np.isfinite(out["losses"]).all()
    net1 = os.path.join(trainer.exp_dir, "net_1")
    _, ext = cli.main(common + ["--extract-feats", "--model-path", net1, "--device", "cpu",
                                "--mouth-embedding-out-path", str(tmp_path / "pem")])
    tree = _npz_tree(str(tmp_path / "pem"))
    assert len(tree) == 6 and all(v.shape == (1, 6, 512) and v.dtype == np.float32
                                  for v in tree.values())
    again = VideoTrainer(trainer.model_cfg, trainer.num_classes, device="cpu")
    again.load(net1)
    from deeplip_tpu_torch.data.video_dataset import VideoClipBatches, scan_clip_dir
    direct = again.extract_clip_features(VideoClipBatches(
        scan_clip_dir(data), batch_size=4, shuffle=False, pre_crop=again.crop_size))
    for name, feats in direct.items():
        assert np.array_equal(tree[name + ".npz"][0], feats), name

    # the JAX CLI trains; its checkpoint, carried across, extracts the same tree
    jax_cli.main(common + ["--epochs", "1", "--exp-root", str(tmp_path / "jexp"),
                           "--log-time", "t"])
    jnet = os.path.join(str(tmp_path / "jexp"), "t", "net_1")
    jax_cli.main(common + ["--extract-feats", "--model-path", jnet,
                           "--mouth-embedding-out-path", str(tmp_path / "jem")])
    jtree = jax_ckpt.load_checkpoint(str(tmp_path / "jexp" / "t"), 1)
    carried = str(tmp_path / "net_carried")
    torch.save({"epoch": 1, "state_dict": lipreading_state_dict(
        jax.tree_util.tree_map(np.asarray, jtree["params"]),
        jax.tree_util.tree_map(np.asarray, jtree["batch_stats"]))}, carried)
    cli.main(common + ["--extract-feats", "--model-path", carried, "--device", "cpu",
                       "--mouth-embedding-out-path", str(tmp_path / "cem")])
    want, got = _npz_tree(str(tmp_path / "jem")), _npz_tree(str(tmp_path / "cem"))
    assert sorted(want) == sorted(got) and len(want) == 6
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-4, rtol=1e-4, err_msg=name)


def test_video_io_matches_the_jax_module(tmp_path):
    assert video_io.cv2_available() == jax_video_io.cv2_available()
    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    video_io.save2npz(str(tmp_path / "a" / "x.npz"), arr)
    assert np.array_equal(np.load(str(tmp_path / "a" / "x.npz"))["data"], arr)
    (tmp_path / "l.txt").write_text("a \nb\n")
    assert video_io.read_txt_lines(str(tmp_path / "l.txt")) == \
        jax_video_io.read_txt_lines(str(tmp_path / "l.txt")) == ["a", "b"]
    with pytest.raises(FileNotFoundError):
        video_io.read_txt_lines(str(tmp_path / "missing.txt"))
    (tmp_path / "c.json").write_text('{"k": [1, 2]}')
    assert video_io.load_json(str(tmp_path / "c.json")) == {"k": [1, 2]}
