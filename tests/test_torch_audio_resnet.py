"""The port's spectrogram ResNet x-vector (``arch: resnet``) against the JAX
package's ``AudioResNet`` and ``AudioTrainer``.

A narrow network (stage widths 8/16/16, blocks 2/1/1, embedding 16) is
initialised in JAX with random BN parameters and running statistics and
carried into the port by ``interop.from_jax.audio_resnet_state_dict``:

- eval-mode embeddings of a ragged batch with lengths, and the train-mode
  output with every updated running statistic: bar 1e-4;
- the masked pool's ``ceil(len / scale)``: every length at every crop
  length of the config's 200-400 frames, against numpy's float32 and, on
  a sample, the JAX package's own arithmetic;
- 3 f64 LMCL train steps against the JAX ``AudioTrainer``: loss, parameters
  and BN statistics within 1e-9. The JAX module casts the trunk's output to
  float32 before its pool; the port promotes to at least float32 (f64 stays
  f64, as every other module of the port does), so for this f64 comparison
  the test reads the JAX module's ``float32`` as ``float64``;
- a bf16 forward against the JAX bf16 clone (loss within 2e-2) with the
  trunk in bf16 and the pool and head in f32;
- the audio CLI end to end with ``arch: resnet`` on a tiny corpus, and the
  reference exporter's refusal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.data.manifest import SpeakerManifest as JaxManifest
from deeplip_tpu.data.synthetic import make_audio_corpus, make_trial_list
from deeplip_tpu.models import audio_resnet as JAR
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.audio import AudioTrainer as JaxAudioTrainer
from deeplip_tpu_torch.cli import train_audio as cli
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.interop import torch_export as PE
from deeplip_tpu_torch.interop.from_jax import audio_resnet_state_dict, criterion_state_dict
from deeplip_tpu_torch.models.audio_resnet import AudioResNet
from deeplip_tpu_torch.train.audio import AudioTrainer

torch.set_num_threads(1)

N_SPK, BS, T, EMB = 6, 6, 40, 16
WIDTHS, BLOCKS = [8, 16, 16], [2, 1, 1]


def _cfg(**train):
    return {
        "data": {"frames": [T, T], "python_data_config": {
            "rate": 16000, "feat_type": "mfcc", "mfcc": {
                "n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
                "normalize": True, "delta": False, "win_len": 0.025, "win_shift": 0.01}}},
        "model": {"arch": "resnet", "resnet": {
            "input_dim": 1, "hidden_dim": WIDTHS, "residual_block_layers": BLOCKS,
            "fc_layers": 1, "embedding_dim": EMB, "pooling": "average"}},
        "train": {"loss": "LMCL", "scale": 30, "margin": [0.2, 0.2], "type": "sgd", "bs": BS,
                  "lr_decay": 0.1, "lr_decay_step": [1000], "epoch": 1,
                  "sgd": {"init_lr": 0.01, "weight_decay": 1e-5, "momentum": 0.9}, **train},
        "test": {},
    }


def _randomise_bn(params, stats, rng):
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "kernel" not in sub:
            sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape)
            sub["bias"] = rng.normal(0, 0.2, sub["bias"].shape)
            if name in stats:
                stats[name]["mean"] = rng.normal(0, 0.3, sub["scale"].shape)
                stats[name]["var"] = rng.uniform(0.5, 2.0, sub["scale"].shape)
        else:
            _randomise_bn(sub, stats.get(name, {}), rng)


def _jax_model(dtype="float32", seed=0):
    model = JAR.AudioResNet(stage_widths=tuple(WIDTHS), stage_blocks=tuple(BLOCKS),
                            embedding_dim=EMB)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, T, 24), jnp.float32))
    params = jax.tree_util.tree_map(np.array, v["params"])
    stats = jax.tree_util.tree_map(np.array, v["batch_stats"])
    _randomise_bn(params, stats, np.random.default_rng(seed + 100))
    cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), t)  # noqa: E731
    return model, cast(params), cast(stats)


def _port_model(params, stats):
    net = AudioResNet(WIDTHS, BLOCKS, EMB)
    net.load_state_dict(audio_resnet_state_dict(params, stats), strict=True)
    return net


def test_state_dict_layout_and_config():
    _, params, stats = _jax_model()
    sd = audio_resnet_state_dict(params, stats)
    net = AudioResNet.from_config(_cfg()["model"])
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    assert "stage1_block0.downsample.0.weight" in sd and "stem_bn.running_var" in sd
    assert net.receptive_field == 1
    assert torch.equal(net.valid_lengths(torch.tensor([3, 9])), torch.tensor([3, 9]))


def test_eval_and_train_forward_match_jax():
    model, params, stats = _jax_model()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, T, 24)).astype(np.float32)
    lengths = np.array([T, 33, 9, 1], np.int32)
    net = _port_model(params, stats).eval()
    variables = {"params": params, "batch_stats": stats}
    want = model.apply(variables, jnp.asarray(x), lengths=jnp.asarray(lengths),
                       method=model.extract_embedding)
    got = net.extract_embedding(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    out, upd = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net.train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    want_sd = audio_resnet_state_dict(params, jax.tree_util.tree_map(np.asarray,
                                                                     upd["batch_stats"]))
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(net.state_dict()[k].numpy(), v.numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=k)


def _t_out(t: int) -> int:
    # two stride-2 stages of 3x3 / pad 1 convs
    for _ in range(2):
        t = (t - 1) // 2 + 1
    return t


def test_pool_lengths_round_as_float32_at_every_crop():
    from deeplip_tpu_torch.models.audio_resnet import MaskedGlobalMean

    pool = MaskedGlobalMean()
    for t in range(200, 401):
        t_out = _t_out(t)
        lens = np.arange(1, t + 1, dtype=np.int32)
        want = np.maximum(np.ceil(lens.astype(np.float32) / np.float32(t / t_out)), 1)
        h = torch.zeros((t, t_out, 1, 1))
        h[torch.arange(t), torch.from_numpy(want.astype(np.int64) - 1)] = 1.0
        # a row's mean is 1 / valid exactly where the port's valid count agrees
        got = pool(h, torch.from_numpy(lens), t)[:, 0]
        np.testing.assert_array_equal(got.numpy(), (1.0 / want).astype(np.float32),
                                      err_msg=f"crop of {t} frames")
        if t in (200, 203, 299, 331, 400):
            jax_valid = np.asarray(jnp.maximum(jnp.ceil(
                jnp.asarray(lens).astype(jnp.float32) / (t / t_out)), 1.0))
            np.testing.assert_array_equal(jax_valid, want)


class _Float64Pool:
    """``jax.numpy`` with ``float32`` read as ``float64``, for the JAX
    module's cast before its pool in the f64 comparison."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_three_f64_steps_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(JAR, "jnp", _Float64Pool())
    steps, tol = 3, 1e-9
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((steps, BS, T, 24))
    labels = rng.integers(0, N_SPK, (steps, BS)).astype(np.int64)
    cfg = _cfg()
    with jax.enable_x64(True):
        jtr = JaxAudioTrainer(JaxConfig(cfg), n_spk=N_SPK, exp_root=str(tmp_path / "jax"))
        assert isinstance(jtr.model, JAR.AudioResNet)
        jtr.model = jtr.model.clone(dtype=jnp.float64)
        jtr.train_model = jtr.model
        x = jnp.zeros((2, T, 24), jnp.float64)
        mvars = jtr.model.init(jax.random.PRNGKey(0), x)
        cvars = jtr.criterion.init(jax.random.PRNGKey(1), jtr.model.apply(mvars, x),
                                   jnp.zeros((2,), jnp.int32))
        f64 = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float64), t)  # noqa
        params = {"model": f64(mvars["params"]), "criterion": f64(cvars["params"])}
        stats = {"model": f64(mvars["batch_stats"])}
        _randomise_bn(params["model"], stats["model"], np.random.default_rng(5))
        params, stats = f64(params), f64(stats)
        state = JState.TrainState(params=params, batch_stats=stats,
                                  opt_state=jtr.tx.init(params), step=0)
        ptr = AudioTrainer(Config(cfg), device="cpu", n_spk=N_SPK,
                           exp_root=str(tmp_path / "port"))
        assert isinstance(ptr.model, AudioResNet)
        ptr.model.to(torch.float64)
        ptr.criterion.to(torch.float64)
        ptr.model.load_state_dict(audio_resnet_state_dict(params["model"], stats["model"]))
        ptr.criterion.load_state_dict(criterion_state_dict(params["criterion"]))
        for k in range(steps):
            state, jm = jtr._train_step_feats(state, jnp.asarray(feats[k]),
                                              jnp.asarray(labels[k]), jnp.float64(0.2))
            pm = ptr.train_step_feats(torch.tensor(feats[k]), torch.tensor(labels[k]), 0.2)
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=tol,
                                       atol=tol, err_msg=f"loss, step {k}")
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        want = audio_resnet_state_dict(tree(state.params["model"]),
                                       tree(state.batch_stats["model"]))
        got = ptr.model.state_dict()
        assert set(got) == set(want)
        for name, v in want.items():
            if name.endswith("num_batches_tracked"):
                assert int(got[name]) == steps, name
                continue
            np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=tol, rtol=tol,
                                       err_msg=name)
        np.testing.assert_allclose(ptr.criterion.weights.detach().numpy(),
                                   np.asarray(state.params["criterion"]["weights"]),
                                   atol=tol, rtol=tol)


def test_bf16_forward_matches_jax_bf16_clone():
    model, params, stats = _jax_model()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, T, 24)).astype(np.float32)
    out, _ = model.clone(dtype=jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    net = _port_model(params, stats).train()
    seen = {}

    def dtype_of(name):
        def hook(mod, args, out):
            seen[name] = out.dtype
        return hook

    hooks = [net.stage2_block0.register_forward_hook(dtype_of("block")),
             net.pooling.register_forward_hook(dtype_of("pool"))]
    with torch.no_grad():
        got = net(torch.from_numpy(x), compute_dtype=torch.bfloat16)
    for h in hooks:
        h.remove()
    assert seen == {"block": torch.bfloat16, "pool": torch.float32}
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-2, rtol=2e-2)


def test_cli_trains_and_evaluates_the_resnet_arch(tmp_path):
    root = str(tmp_path / "corpus")
    make_audio_corpus(root, n_spk=3, utts_per_spk=4, duration=1.5)
    trials = os.path.join(root, "trials.txt")
    make_trial_list(trials, JaxManifest.load(os.path.join(root, "manifest.csv")), n_trials=40)
    cfg = _cfg()
    cfg["data"].update({"frames": [40, 60], "train_manifest": os.path.join(root, "manifest.csv"),
                        "test_root": root, "trial_grid": trials})
    cfg["train"].update({"bs": 6, "epoch": 1, "frame_buckets": 2, "loader_workers": 2,
                         "log_every": 0, "compute_dtype": "bf16", "steps_per_dispatch": 2})
    cfg["test"] = {"eval_grid": True, "use_cos": True, "bucket_frames": 50, "batch_size": 8}
    path = str(tmp_path / "audio.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    trainer, out = cli.main(["--config", path, "--mode", "train", "--exp-root",
                             str(tmp_path / "exp"), "--log-time", "t", "--device", "cpu"])
    assert isinstance(trainer.model, AudioResNet)
    assert trainer.compute_dtype == torch.bfloat16
    assert len(out["losses"]) == trainer.step and np.all(np.isfinite(out["losses"]))
    assert 0.0 <= out["eer"] <= 1.0
    with pytest.raises(ValueError, match="TDNN"):
        PE.save_reference_audio_checkpoint(str(tmp_path / "x.pth"),
                                           trainer.model.state_dict())
