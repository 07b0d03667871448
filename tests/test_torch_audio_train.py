"""The port's audio x-vector trainer against the JAX package's ``AudioTrainer``.

Both trainers start from the same weights (the JAX init, carried across by
``interop.from_jax``) and take the same steps on the same batches, the
port's ``train_step_feats`` / ``train_step`` against the JAX trainer's
``_train_step_feats`` / ``_train_step``, as ``scripts/parity_check.py
--train-parity`` runs the reference's torch loop against the JAX trainer:

- 12 f64 LMCL steps with the margin flipping mid-run: loss, parameters and
  BN statistics within 1e-9;
- 12 f32 steps of the CrossEntropy recipe: loss within 1e-6;
- 3 f32 steps of the CrossEntropy recipe from int16 PCM through the
  front-end (the plain front-end on both sides): loss and parameters within
  1e-4. The two plain front-ends agree to about 2e-5 on the CMVN'd
  features, and the scale-30 LMCL amplifies a feature difference of that
  size to about 1e-2 of its loss within 3 f32 steps (the JAX trainer
  against itself moves that far); the f64 LMCL steps above hold the LMCL
  step exactly, so this test runs the smooth recipe;
- a bf16 forward against the JAX bf16 model: loss within 2e-2 relative,
  and the bf16 recipe's dtypes audited, each planted fault caught.

Also: the MultiStep schedule, SGD/Adam against optax (with the finetune
freeze), checkpoints with resume and the LR fast-forward, checkpoint
averaging against the JAX mean, and the CLI end to end on a tiny corpus.
"""

import contextlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.data.manifest import SpeakerManifest as JaxManifest
from deeplip_tpu.data.synthetic import make_audio_corpus, make_trial_list
from deeplip_tpu.interop.torch_export import (export_criterion_state_dict,
                                              export_speaker_embnet_state_dict)
from deeplip_tpu.train import checkpoint as JC
from deeplip_tpu.train import schedules as JS
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.audio import AudioTrainer as JaxAudioTrainer
from deeplip_tpu_torch.cli import train_audio as cli
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.interop.from_jax import criterion_state_dict, speaker_embnet_state_dict
from deeplip_tpu_torch.train.audio import AudioExtractor, AudioTrainer
from deeplip_tpu_torch.train.schedules import multistep_schedule
from deeplip_tpu_torch.train.state import build_optimizer

torch.set_num_threads(1)

N_SPK, BS, T, EMB = 12, 16, 120, 32
CONTEXTS, HIDDEN = [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]], [32, 32, 64]
MFCC = {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True, "normalize": True,
        "delta": False, "win_len": 0.025, "win_shift": 0.01}


def _cfg(loss="LMCL", **train):
    return {
        "data": {"frames": [T, T], "python_data_config": {
            "rate": 16000, "feat_type": "mfcc", "mfcc": MFCC}},
        "model": {"arch": "tdnn", "tdnn": {
            "input_dim": 24, "hidden_dim": HIDDEN, "context": CONTEXTS,
            "tdnn_layers": len(CONTEXTS), "embedding_dim": EMB, "pooling": "statistic",
            "attention_hidden_size": 8, "bn_first": True}},
        "train": {"loss": loss, "scale": 30, "margin": [0.2, 0.3], "type": "sgd", "bs": BS,
                  "lr_decay": 0.1, "lr_decay_step": [1000], "epoch": 1,
                  "sgd": {"init_lr": 0.01, "weight_decay": 1e-5, "momentum": 0.9}, **train},
        "test": {},
    }


def _randomise_bn(params, rng):
    for name, sub in params.items():
        if isinstance(sub, dict):
            if "scale" in sub and "kernel" not in sub:
                sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape)
                sub["bias"] = rng.normal(0, 0.2, sub["bias"].shape)
            else:
                _randomise_bn(sub, rng)


def _pair(cfg, dtype, tmp_path):
    """The JAX trainer with a state, and the port's trainer with the same
    weights."""
    jtr = JaxAudioTrainer(JaxConfig(cfg), n_spk=N_SPK, exp_root=str(tmp_path / "jax"))
    jdt = getattr(jnp, dtype)
    if dtype == "float64":
        jtr.model = jtr.model.clone(dtype=jnp.float64)
        jtr.train_model = jtr.model
    x = jnp.zeros((2, T, 24), jdt)
    mvars = jtr.model.init(jax.random.PRNGKey(0), x)
    cvars = jtr.criterion.init(jax.random.PRNGKey(1), jtr.model.apply(mvars, x),
                               jnp.zeros((2,), jnp.int32))
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, dtype), t)  # noqa: E731
    params = {"model": to_np(mvars["params"]), "criterion": to_np(cvars["params"])}
    _randomise_bn(params["model"], np.random.default_rng(5))
    params = to_np(params)
    stats = {"model": to_np(mvars["batch_stats"])}
    state = JState.TrainState(params=params, batch_stats=stats,
                              opt_state=jtr.tx.init(params), step=0)
    ptr = AudioTrainer(Config(cfg), device="cpu", n_spk=N_SPK, exp_root=str(tmp_path / "port"))
    ptr.model.to(getattr(torch, dtype))
    ptr.criterion.to(getattr(torch, dtype))
    ptr.model.load_state_dict(speaker_embnet_state_dict(params["model"], stats["model"]))
    ptr.criterion.load_state_dict(criterion_state_dict(params["criterion"]))
    return jtr, state, ptr


def _compare_states(state, ptr, tol, steps):
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = export_speaker_embnet_state_dict(tree(state.params["model"]),
                                            tree(state.batch_stats["model"]))
    got = ptr.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == steps, k
            continue
        np.testing.assert_allclose(got[k].numpy(), v, atol=tol, rtol=tol, err_msg=k)
    for k, v in export_criterion_state_dict(tree(state.params["criterion"])).items():
        np.testing.assert_allclose(ptr.criterion.state_dict()[k].numpy(), v, atol=tol,
                                   rtol=tol, err_msg=k)


def _feature_batches(dtype, steps, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((steps, BS, T, 24)).astype(dtype)
    labels = rng.integers(0, N_SPK, (steps, BS)).astype(np.int64)
    return feats, labels


def _run_feats(jtr, state, ptr, feats, labels, margins, dtype):
    losses = []
    for k in range(len(feats)):
        state, jm = jtr._train_step_feats(state, jnp.asarray(feats[k]), jnp.asarray(labels[k]),
                                          jnp.asarray(margins[k], getattr(jnp, dtype)))
        pm = ptr.train_step_feats(torch.tensor(feats[k]), torch.tensor(labels[k]), margins[k])
        losses.append((float(pm["loss"]), float(jm["loss"])))
        assert float(pm["acc"]) == pytest.approx(float(jm["acc"]))
    return state, np.array(losses)


def test_twelve_f64_lmcl_steps_match_jax(tmp_path):
    steps, tol = 12, 1e-9
    feats, labels = _feature_batches(np.float64, steps)
    margins = [0.2 if k < steps // 2 else 0.3 for k in range(steps)]
    with jax.enable_x64(True):
        jtr, state, ptr = _pair(_cfg("LMCL"), "float64", tmp_path)
        state, losses = _run_feats(jtr, state, ptr, feats, labels, margins, "float64")
        np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=tol, atol=tol)
        assert ptr.step == steps
        _compare_states(state, ptr, tol, steps)


def test_twelve_f32_cross_entropy_steps_match_jax(tmp_path):
    steps = 12
    feats, labels = _feature_batches(np.float32, steps, seed=1)
    jtr, state, ptr = _pair(_cfg("CrossEntropy"), "float32", tmp_path)
    _, losses = _run_feats(jtr, state, ptr, feats, labels, [0.2] * steps, "float32")
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-6, atol=1e-6)
    assert losses[-1, 0] < losses[0, 0]


def test_three_f32_steps_from_pcm_match_jax(tmp_path):
    from deeplip_tpu_torch.ops.framing import samples_for_frames

    steps, tol = 3, 1e-4
    rng = np.random.default_rng(2)
    s = samples_for_frames(T, 0.025, 0.01, 16000)
    pcm = rng.integers(-6000, 6000, (steps, BS, s)).astype(np.int16)
    labels = rng.integers(0, N_SPK, (steps, BS)).astype(np.int64)
    jtr, state, ptr = _pair(_cfg("CrossEntropy"), "float32", tmp_path)
    assert jtr.feature_backend == "xla"
    for k in range(steps):
        state, jm = jtr._train_step(state, jnp.asarray(pcm[k]), jnp.asarray(labels[k]),
                                    jnp.float32(0.2))
        pm = ptr.train_step(torch.tensor(pcm[k]), torch.tensor(labels[k]), 0.2)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=tol, atol=tol)
    _compare_states(state, ptr, tol, steps)


def test_bf16_forward_matches_jax_bf16_model(tmp_path):
    feats, labels = _feature_batches(np.float32, 1, seed=3)
    jtr, state, ptr = _pair(_cfg("LMCL", compute_dtype="bf16"), "float32", tmp_path)
    assert ptr.compute_dtype == torch.bfloat16
    emb, _ = jtr.train_model.apply(
        {"params": state.params["model"], "batch_stats": state.batch_stats["model"]},
        jnp.asarray(feats[0]), train=True, mutable=["batch_stats"])
    jloss, _ = jtr.criterion.apply({"params": state.params["criterion"]}, emb,
                                   jnp.asarray(labels[0]), margin=0.2)
    ptr.model.train()
    x = torch.tensor(feats[0])
    with torch.no_grad():
        pemb = ptr.model(x, compute_dtype=torch.bfloat16)
        ploss, _ = ptr.criterion(pemb, torch.tensor(labels[0]), margin=0.2)
        f32_loss, _ = ptr.criterion(ptr.model(x), torch.tensor(labels[0]), margin=0.2)
    assert pemb.dtype == torch.float32   # pooling and the head run in f32
    assert float(ploss) == pytest.approx(float(jloss), rel=2e-2)
    assert float(ploss) != float(f32_loss)   # the blocks did compute in bf16
    metrics = ptr.train_step_feats(x, torch.tensor(labels[0]), 0.2)
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in ptr.model.parameters())


@pytest.mark.parametrize("fault", [None, "bn_stats_bf16", "pool_bf16", "head_bf16"])
def test_bf16_recipe_audit(fault, tmp_path):
    """The bf16 forward keeps its recipe (bf16 conv blocks; BN statistics,
    pooling and the cosine logits >= f32), as ``chip_smoke.bf16_audit``
    holds it on the card, and each planted fault breaks it. (The TF32
    fault exists only on the card.)"""
    import chip_smoke

    feats, labels = _feature_batches(np.float32, 1, seed=3)
    tr = AudioTrainer(Config(_cfg("LMCL", compute_dtype="bf16")), device="cpu", n_spk=N_SPK,
                      exp_root=str(tmp_path))
    tr.model.train()
    record = {}
    planted = (chip_smoke.planted_bf16_fault(fault, tr.model) if fault
               else contextlib.nullcontext())
    with torch.no_grad(), planted, chip_smoke.bf16_audit(tr.model, tr.criterion, record):
        tr.criterion(tr.model(torch.tensor(feats[0]), compute_dtype=torch.bfloat16),
                     torch.tensor(labels[0]), margin=0.2)
    failures = chip_smoke.bf16_audit_failures(record)
    assert bool(failures) == (fault is not None), (fault, record)
    # the fault is taken out again
    assert "forward" not in tr.model.pooling.__dict__


def test_config_options_that_are_not_ported_raise():
    # grouped dispatch is ported: a group of 4 equals 4 single steps
    feats, labels = _feature_batches(np.float32, 4, seed=8)
    single, grouped = (AudioTrainer(Config(_cfg(steps_per_dispatch=k)), device="cpu",
                                    n_spk=N_SPK) for k in (1, 4))
    assert grouped.steps_per_dispatch == 4
    pcm = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, BS, 160 * (T - 1) + 400)).astype(np.float32))
    want = [float(single.train_step(pcm[i], torch.tensor(labels[i]), 0.3)["loss"])
            for i in range(4)]
    got = grouped.train_group(pcm, torch.tensor(np.stack(labels)), 0.3)
    assert got["loss"].tolist() == want and grouped.step == 4
    for a, b in zip(single.model.state_dict().values(), grouped.model.state_dict().values()):
        assert torch.equal(a, b)
    cfg = _cfg()
    cfg["data"]["data_format"] = "kaldi"
    # the Kaldi path is ported (tests/test_torch_kaldi_train.py): a Kaldi
    # config without its trainset tables has nothing to train on
    kaldi = AudioTrainer(Config(cfg), device="cpu", n_spk=2)
    assert kaldi.pipeline is None and kaldi.manifest is None
    with pytest.raises(RuntimeError, match="Kaldi trainset"):
        kaldi.train(epochs=1)
    with pytest.raises(FileNotFoundError):
        AudioTrainer(Config(_cfg(resume="/nonexistent/net_3")), device="cpu", n_spk=2)


# ----------------------------------------------------------- schedules, optimizers
def test_multistep_schedule_equals_jax_at_its_boundaries():
    with jax.enable_x64(True):
        jsched = JS.multistep_schedule(0.01, [15, 25], 0.1, 7)
        sched = multistep_schedule(0.01, [15, 25], 0.1, 7)
        for step in (0, 1, 104, 105, 106, 174, 175, 176, 1000):
            assert sched(step) == float(jsched(step)), step
    assert sched(104) == 0.01 and sched(105) == pytest.approx(1e-3)


@pytest.mark.parametrize("opt_type,finetune", [("sgd", False), ("adam", False),
                                               ("sgd", True)])
def test_optimizers_match_optax(opt_type, finetune):
    rng = np.random.default_rng(4)
    tree = {"model": {"w": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)},
            "criterion": {"weights": rng.standard_normal((5, 4))}}
    grads = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape), tree)
             for _ in range(6)]
    mask = {"model": False, "criterion": True} if finetune else None
    with jax.enable_x64(True):
        jsched = JS.multistep_schedule(0.1, [1, 2], 0.1, 2)
        tx = JState.build_optimizer(opt_type, jsched, momentum=0.9, weight_decay=1e-3,
                                    trainable_mask=mask)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        opt_state = tx.init(jparams)
        for g in grads:
            updates, opt_state = tx.update(g, opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
    params = {grp: {k: torch.nn.Parameter(torch.tensor(v)) for k, v in sub.items()}
              for grp, sub in tree.items()}
    sched = multistep_schedule(0.1, [1, 2], 0.1, 2)
    opt = build_optimizer(opt_type, {g: sub.values() for g, sub in params.items()},
                          sched(0), momentum=0.9, weight_decay=1e-3, trainable_mask=mask)
    for step, g in enumerate(grads):
        for grp, sub in params.items():
            for k, p in sub.items():
                p.grad = torch.tensor(g[grp][k])
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
    for grp, sub in params.items():
        for k, p in sub.items():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, np.asarray(jparams[grp][k]), rtol=1e-12, atol=1e-12)
            if finetune and grp == "model":
                np.testing.assert_array_equal(got, tree[grp][k])   # bit-unchanged


def test_finetune_freezes_the_backbone_and_trains_the_head(tmp_path):
    feats, labels = _feature_batches(np.float32, 1, seed=6)
    ptr = AudioTrainer(Config(_cfg("LMCL", train_type="finetune")), device="cpu",
                       n_spk=N_SPK)
    params = {k: v.clone() for k, v in ptr.model.named_parameters()}
    stats = {k: v.clone() for k, v in ptr.model.named_buffers()}
    head = ptr.criterion.weights.detach().clone()
    x, y = torch.tensor(feats[0]), torch.tensor(labels[0])
    losses = [float(ptr.train_step_feats(x, y, 0.2)["loss"]) for _ in range(5)]
    for k, v in ptr.model.named_parameters():
        assert torch.equal(v, params[k]), k
    assert not torch.equal(ptr.model.tdnn[0].bn.running_mean, stats["tdnn.0.bn.running_mean"])
    assert int(ptr.model.bn2.num_batches_tracked) == 5
    assert not torch.equal(ptr.criterion.weights.detach(), head)
    assert losses[-1] < losses[0]


# ----------------------------------------------------------- checkpoints, CLI
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("audio_cli"))
    make_audio_corpus(root, n_spk=3, utts_per_spk=4, duration=1.5)
    trial_path = os.path.join(root, "trials.txt")
    make_trial_list(trial_path, JaxManifest.load(os.path.join(root, "manifest.csv")),
                    n_trials=60)
    return root, trial_path


def _corpus_cfg(root, trial_path, **train):
    cfg = _cfg("LMCL", **train)
    cfg["data"].update({"frames": [40, 60], "train_manifest": os.path.join(root, "manifest.csv"),
                        "test_root": root, "trial_grid": trial_path})
    cfg["train"].update({"bs": 8, "epoch": 2, "frame_buckets": 2, "loader_workers": 2,
                         "log_every": 0, "lr_decay_step": [1],
                         "sgd": {"init_lr": 0.05, "weight_decay": 1e-5, "momentum": 0.9}})
    cfg["test"] = {"eval_grid": True, "use_cos": True, "bucket_frames": 50, "batch_size": 8}
    return cfg


def test_save_resume_and_lr_fast_forward(corpus, tmp_path):
    root, trial_path = corpus
    cfg = _corpus_cfg(root, trial_path)
    tr = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path), log_time="run")
    bpe = tr.pipeline.batches_per_epoch()
    assert tr.n_spk == 3 and bpe >= 2 and tr.pipeline._resolve_transport() == "int16"
    losses = tr.train(epochs=1)
    assert len(losses) == bpe and all(np.isfinite(losses))
    assert tr.step == bpe and tr.optimizer.param_groups[0]["lr"] == 0.05
    tree = torch.load(os.path.join(tr.exp_dir, "net_1"), weights_only=True)
    assert set(tree) == {"epoch", "state_dict", "criterion", "optimizer"}

    again = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path), log_time="other")
    again.load(os.path.join(tr.exp_dir, "net_1"))
    assert again.current_epoch == 1 and again.step == bpe
    assert again.exp_dir == tr.exp_dir
    assert again.schedule(again.step) == pytest.approx(0.005)   # decayed after epoch 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    assert not again.optimizer.state   # momentum restored only on request
    again.load(os.path.join(tr.exp_dir, "net_1"), restore_optimizer=True)
    buf = next(iter(again.optimizer.state.values()))["momentum_buffer"]
    assert torch.equal(buf, next(iter(tr.optimizer.state.values()))["momentum_buffer"])

    # the extractor reads the trainer's checkpoints
    ext = AudioExtractor(Config(cfg), device="cpu")
    ext.load_checkpoint(os.path.join(tr.exp_dir, "net_1"))
    assert torch.equal(ext.model.fc2.weight, tr.model.fc2.weight)

    # finetune from it: the backbone loaded and frozen, the head fresh, epoch 0
    fine = AudioTrainer(Config(_corpus_cfg(root, trial_path, train_type="finetune",
                                           resume=os.path.join(tr.exp_dir, "net_1"))),
                        device="cpu", exp_root=str(tmp_path), log_time="fine")
    assert fine.loaded_checkpoint and fine.current_epoch == 0 and fine.step == 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(fine.model.state_dict()[k], v), k
    assert not torch.equal(fine.criterion.weights, tr.criterion.weights)
    assert [g["name"] for g in fine.optimizer.param_groups] == ["criterion"]

    # auto_resume continues from the newest net_<epoch>
    third = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path), log_time="run")
    more = third.train(epochs=2, auto_resume=True)
    assert len(more) == bpe and third.current_epoch == 2 and third.step == 2 * bpe
    assert os.path.exists(os.path.join(tr.exp_dir, "net_2"))


def test_model_average_equals_jax_mean(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    tr = AudioTrainer(Config(_cfg("CrossEntropy")), device="cpu", n_spk=N_SPK,
                      exp_root=str(tmp_path), log_time="avg")
    trees = {}
    for epoch in (1, 2, 3):
        for p in list(tr.model.parameters()) + list(tr.criterion.parameters()):
            p.data = torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
        tr.model.bn1.running_var.copy_(torch.tensor(rng.uniform(0.5, 2.0, EMB)))
        tr.model.bn1.num_batches_tracked.fill_(10 * epoch)
        tr.current_epoch = epoch
        tr.save(epoch)
        trees[epoch] = {"epoch": epoch, "params": {
            **{k: v.numpy().copy() for k, v in tr.model.state_dict().items()},
            **{"crit." + k: v.numpy().copy() for k, v in tr.criterion.state_dict().items()}}}
    tr.model_average(avg_num=2)
    saved = {}
    monkeypatch.setattr(JC, "load_checkpoint", lambda exp_dir, tag: trees[tag])
    monkeypatch.setattr(JC, "save_checkpoint", lambda exp_dir, tag, tree: saved.update(tree))
    want = JC.average_checkpoints("unused", [3, 2])["params"]
    avg = torch.load(os.path.join(tr.exp_dir, "net_avg"), weights_only=True)
    assert avg["epoch"] == 3
    for k, v in tr.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(avg["state_dict"][k].numpy(), want[k], err_msg=k)
    for k, v in tr.criterion.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want["crit." + k], err_msg=k)
    assert int(tr.model.bn1.num_batches_tracked) == 30   # integers from the first
    assert saved["params"] is want


def test_cli_modes_end_to_end(corpus, tmp_path, capsys):
    root, trial_path = corpus
    cfg = _corpus_cfg(root, trial_path)
    dev_root = str(tmp_path / "dev")
    os.makedirs(dev_root)
    names = []
    for s, spk in enumerate(JaxManifest.load(os.path.join(root, "manifest.csv")).speakers):
        for u in spk:
            names.append(f"s{s:02d}_{os.path.basename(u.path)}")
            shutil.copy(u.path, os.path.join(dev_root, names[-1]))
    with open(tmp_path / "dev.txt", "w") as fh:
        fh.write("\n".join(names) + "\n")
    cfg["data"].update({"trial_lomgrid": trial_path, "plda_dev_list": str(tmp_path / "dev.txt"),
                        "dev_root": dev_root})
    path = str(tmp_path / "audio.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    exp = str(tmp_path / "exp")
    common = ["--config", path, "--exp-root", exp, "--log-time", "t", "--device", "cpu"]

    trainer, out = cli.main(common + ["--mode", "train"])
    run = os.path.join(exp, "t")
    for tag in ("net_1", "net_2", "net_avg"):
        assert os.path.exists(os.path.join(run, tag)), tag
    assert trainer.current_epoch == 2 and len(out["losses"]) == trainer.step
    assert 0.0 <= out["eer"] <= 1.0 and "EER:" in capsys.readouterr().out
    assert os.path.exists(os.path.join(run, "test_xv", "s00", "u0.npy"))

    _, again = cli.main(common + ["--mode", "test", "--resume", os.path.join(run, "net_avg")])
    assert again["eer"] == out["eer"]

    cfg["test"].update({"eval_lomgrid": True, "train_plda": True, "use_plda": True})
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    _, av = cli.main(common + ["--mode", "av_test", "--resume", os.path.join(run, "net_avg")])
    assert os.path.exists(os.path.join(run, "plda.npz"))
    for key in ("trial_lomgrid_cosine_eer", "trial_lomgrid_plda_eer", "trial_grid_cosine_eer"):
        assert 0.0 <= av[key] <= 1.0, key

    # stored audio embeddings beside stand-in video ones: both fusions score
    video_root = str(tmp_path / "video_em")
    rng = np.random.default_rng(0)
    for name in os.listdir(os.path.join(run, "test_xv_grid")):
        for utt in os.listdir(os.path.join(run, "test_xv_grid", name)):
            os.makedirs(os.path.join(video_root, name), exist_ok=True)
            np.save(os.path.join(video_root, name, utt), rng.standard_normal(8).astype(np.float32))
    cfg["data"]["video_embedding_root"] = video_root
    for fusion_type in ("feature", "score"):
        cfg["test"]["fusion_type"] = fusion_type
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        _, fused = cli.main(common + ["--mode", "av_fusion"])
        assert 0.0 <= fused["trial_grid_fusion_eer"] <= 1.0


def test_chip_smoke_trains_the_config_file(tmp_path):
    """``chip_smoke.py`` phase 11 trains ``conf/audio_config.yaml`` as the
    file reads (it loads it itself: the port reads YAML without pyyaml),
    with only its paths and epoch count set."""
    import yaml

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "conf", "audio_config.yaml")) as fh:
        want = yaml.safe_load(fh)
    assert not hasattr(chip_smoke, "AUDIO_CONFIG")
    path = chip_smoke.audio_train_config(str(tmp_path), "m.csv", "t.txt")
    with open(path) as fh:
        got = json.load(fh)
    assert got["data"].pop("train_manifest") == "m.csv"
    assert got["data"].pop("trial_grid") == "t.txt"
    assert got["data"].pop("test_root") == str(tmp_path)
    assert got["train"].pop("epoch") == chip_smoke.TRAIN_EPOCHS
    for key in ("train_manifest", "trial_grid", "test_root"):
        del want["data"][key]
    del want["train"]["epoch"]
    assert got == want
