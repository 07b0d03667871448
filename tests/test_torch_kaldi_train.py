"""The port's ``AudioTrainer`` on Kaldi features (``data_format: kaldi``)
against the JAX package's.

- The JAX test's tiny Kaldi config (``tests/test_kaldi_training.py``)
  through the port's trainer: the pipeline's batches bit-equal to the JAX
  trainer's, one epoch trained, its checkpoint, metrics and TensorBoard
  file written, and ``load`` fast-forwarding the step.
- f64 steps on the pipeline's own batches against the JAX
  ``_train_step_feats``: loss, parameters and BN statistics within 1e-9,
  the bar of the 12 f64 LMCL steps (``tests/test_torch_audio_train.py``).
- A bf16 Kaldi step against the JAX bf16 step (2e-2 relative, the bf16
  forward's bar there).
- Feature batches flush a pending group (``steps_per_dispatch > 1``) as the
  JAX ``_group_batches`` does, and a grouped Kaldi run equals a single one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.interop.kaldi import write_ark_scp
from deeplip_tpu.interop.torch_export import (export_criterion_state_dict,
                                              export_speaker_embnet_state_dict)
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.audio import AudioTrainer as JaxAudioTrainer
from deeplip_tpu.train.audio import _group_batches
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.kaldi_dataset import KaldiTrainPipeline
from deeplip_tpu_torch.interop.from_jax import criterion_state_dict, speaker_embnet_state_dict
from deeplip_tpu_torch.train.audio import AudioTrainer, group_batches

torch.set_num_threads(1)


def _corpus(root, n_spk=3, utts=3, dim=24):
    """``tests/test_kaldi_training.py``'s corpus, by the JAX writer."""
    rng = np.random.default_rng(0)
    utt2feat, lines = {}, []
    for s in range(n_spk):
        names = []
        for u in range(utts):
            name = f"spk{s}_utt{u}"
            t = rng.integers(80, 140)
            utt2feat[name] = (rng.standard_normal((t, dim))
                              + 2.0 * np.sin(np.arange(dim) * (s + 1))).astype(np.float32)
            names.append(name)
        lines.append(f"spk{s} " + " ".join(names))
    ark, scp = str(root / "feats.ark"), str(root / "feats.scp")
    write_ark_scp(utt2feat, ark, scp)
    spk2utt = root / "spk2utt"
    spk2utt.write_text("\n".join(lines) + "\n")
    return str(spk2utt), scp


def _cfg(spk2utt, scp, **train):
    """``tests/test_kaldi_training.py``'s config."""
    return {
        "data": {
            "frames": [40, 60], "data_format": "kaldi",
            "kaldi_data_config": {"trainset": {"nn_spk2utt": spk2utt, "nn_feat_scp": scp}},
            "python_data_config": {
                "rate": 16000, "feat_type": "mfcc",
                "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
                         "normalize": True, "delta": False, "win_len": 0.025,
                         "win_shift": 0.01}},
        },
        "model": {"arch": "tdnn", "tdnn": {
            "input_dim": 24, "hidden_dim": [32, 32, 64],
            "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]], "tdnn_layers": 3,
            "embedding_dim": 16, "pooling": "statistic", "attention_hidden_size": 8,
            "bn_first": True}},
        "train": {"type": "sgd", "bs": 8, "lr_decay": 0.1, "lr_decay_step": [50], "epoch": 1,
                  "loss": "LMCL", "scale": 30, "margin": [0.2, 0.2], "frame_buckets": 2,
                  "log_every": 0, "sgd": {"init_lr": 0.05, "weight_decay": 0, "momentum": 0.9},
                  **train},
        "test": {},
    }


def _randomise_bn(params, rng):
    for sub in params.values():
        if isinstance(sub, dict):
            if "scale" in sub and "kernel" not in sub:
                sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape)
                sub["bias"] = rng.normal(0, 0.2, sub["bias"].shape)
            else:
                _randomise_bn(sub, rng)


def _pair(cfg, dtype, tmp_path):
    """The JAX trainer with a state, and the port's trainer with the same
    weights, both on the Kaldi tables of ``cfg``."""
    jtr = JaxAudioTrainer(JaxConfig(cfg), exp_root=str(tmp_path / "jax"))
    if dtype == "float64":
        jtr.model = jtr.model.clone(dtype=jnp.float64)
        jtr.train_model = jtr.model
    x = jnp.zeros((2, 40, 24), getattr(jnp, dtype))
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
    ptr = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path / "port"))
    ptr.model.to(getattr(torch, dtype))
    ptr.criterion.to(getattr(torch, dtype))
    ptr.model.load_state_dict(speaker_embnet_state_dict(params["model"], stats["model"]))
    ptr.criterion.load_state_dict(criterion_state_dict(params["criterion"]))
    return jtr, state, ptr


def test_tiny_kaldi_config_trains_through_the_port(tmp_path):
    spk2utt, scp = _corpus(tmp_path)
    cfg = _cfg(spk2utt, scp)
    trainer = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path / "exp"),
                           log_time="k0")
    assert trainer.n_spk == 3 and trainer.manifest is None
    assert isinstance(trainer.pipeline, KaldiTrainPipeline)
    jtr = JaxAudioTrainer(JaxConfig(cfg), exp_root=str(tmp_path / "jexp"), log_time="k0")
    assert jtr.n_spk == trainer.n_spk
    bpe = trainer.pipeline.batches_per_epoch()
    assert bpe == jtr.pipeline.batches_per_epoch() > 0
    for epoch in (1, 2):
        for got, want in zip(trainer.pipeline.epoch(epoch), jtr.pipeline.epoch(epoch),
                             strict=True):
            assert got["n_frames"] == want["n_frames"]
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_array_equal(got["feats"], want["feats"])
    losses = trainer.train(epochs=1)
    assert len(losses) == bpe and all(np.isfinite(losses)) and trainer.step == bpe
    assert os.path.isfile(os.path.join(trainer.exp_dir, "net_1"))
    with open(os.path.join(trainer.exp_dir, "train_metrics.jsonl")) as f:
        records = f.readlines()
    assert len(records) == bpe     # log_every 0 logs every step
    events = os.listdir(os.path.join(trainer.exp_dir, "tb"))
    assert len(events) == 1 and events[0].startswith("events.out.tfevents.")
    # resume: the step moves to the epoch's end, as with the wav pipeline
    again = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path / "exp"),
                         log_time="k1")
    again.load(os.path.join(trainer.exp_dir, "net_1"))
    assert (again.current_epoch, again.step) == (1, bpe)
    for a, b in zip(again.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)


def test_f64_kaldi_feature_steps_match_jax(tmp_path):
    tol = 1e-9
    spk2utt, scp = _corpus(tmp_path)
    cfg = _cfg(spk2utt, scp, margin=[0.2, 0.3])
    with jax.enable_x64(True):
        jtr, state, ptr = _pair(cfg, "float64", tmp_path)
        # one batch an epoch: 8 epochs, both crop lengths
        batches = [b for e in range(1, 9) for b in ptr.pipeline.epoch(e)]
        assert len(batches) == 8 and len({b["n_frames"] for b in batches}) == 2
        for k, b in enumerate(batches):
            margin = 0.2 if k < len(batches) // 2 else 0.3
            feats = b["feats"].astype(np.float64)
            state, jm = jtr._train_step_feats(state, jnp.asarray(feats),
                                              jnp.asarray(b["labels"]), jnp.float64(margin))
            pm = ptr.train_step_feats(torch.from_numpy(feats), torch.from_numpy(b["labels"]),
                                      margin)
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=tol,
                                       atol=tol)
            assert float(pm["acc"]) == pytest.approx(float(jm["acc"]))
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        want = export_speaker_embnet_state_dict(tree(state.params["model"]),
                                                tree(state.batch_stats["model"]))
        got = ptr.model.state_dict()
        assert set(got) == set(want)
        for key, v in want.items():
            if key.endswith("num_batches_tracked"):
                assert int(got[key]) == len(batches), key
                continue
            np.testing.assert_allclose(got[key].numpy(), v, atol=tol, rtol=tol, err_msg=key)
        for key, v in export_criterion_state_dict(tree(state.params["criterion"])).items():
            np.testing.assert_allclose(ptr.criterion.state_dict()[key].numpy(), v, atol=tol,
                                       rtol=tol, err_msg=key)


def test_bf16_kaldi_step_matches_the_jax_bf16_step(tmp_path):
    spk2utt, scp = _corpus(tmp_path)
    jtr, state, ptr = _pair(_cfg(spk2utt, scp, compute_dtype="bf16"), "float32", tmp_path)
    assert ptr.compute_dtype == torch.bfloat16
    batch = next(iter(ptr.pipeline.epoch(1)))
    _, jm = jtr._train_step_feats(state, jnp.asarray(batch["feats"]),
                                  jnp.asarray(batch["labels"]), jnp.float32(0.2))
    seen = []
    hook = ptr.model.tdnn[0].register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    pm = ptr.train_step_feats(torch.from_numpy(batch["feats"]),
                              torch.from_numpy(batch["labels"]), 0.2)
    hook.remove()
    assert seen == [torch.bfloat16]
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=2e-2)


def _batches(rng):
    pcm = lambda s: {"pcm": rng.standard_normal((4, s)).astype(np.float32),  # noqa: E731
                     "labels": rng.integers(0, 3, 4), "n_frames": s // 160}
    feats = lambda: {"feats": rng.standard_normal((4, 40, 24)).astype(np.float32),  # noqa: E731
                     "labels": rng.integers(0, 3, 4), "n_frames": 40}
    return [pcm(6400), feats(), pcm(6400), pcm(6400), pcm(6400), feats(), pcm(6400),
            pcm(8000), pcm(8000), pcm(8000), feats()]


def test_feature_batches_flush_groups_as_jax(tmp_path):
    source = _batches(np.random.default_rng(6))
    got, want = list(group_batches(source, 2)), list(_group_batches(source, 2))
    assert [sorted(b) for b in got] == [sorted(b) for b in want]
    assert [b.get("group") for b in got] == [None, None, 2, None, None, None, 2, None, None]
    for g, w in zip(got, want):
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])
    # a Kaldi run with steps_per_dispatch 2 takes the single steps
    spk2utt, scp = _corpus(tmp_path)
    runs = [AudioTrainer(Config(_cfg(spk2utt, scp, steps_per_dispatch=k)), device="cpu",
                         exp_root=str(tmp_path / f"exp{k}")).train(epochs=3) for k in (1, 2)]
    assert runs[0] == runs[1] and len(runs[0]) == 3
