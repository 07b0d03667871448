"""Data-parallel training and extraction across processes, on the CPU with gloo.

The counterpart of ``tests/test_distributed.py``: the JAX package runs its
steps on 1 and 8 virtual devices of one process; the port runs one process
per device, so these tests start gloo process groups (``torch.multiprocessing``
with a ``FileStore`` under ``tmp_path``) and hold their steps against the
same steps in this process without a group:

- the audio (single and grouped), video and fusion steps at world size 2
  against 1: loss within 1e-4 and parameters within 5e-4 (the JAX file's
  bars);
- the tensor-parallel classifier (data 2 x model 2) against pure data
  parallel (data 4) and against one process, at the same bars;
- embeddings across world sizes within 1e-5, with a batch that needs pad
  rows;
- the two-process ``(dcn, data)`` mesh train step;
- the port's audio step at world size 2 against the JAX ``AudioTrainer`` on a
  2-device mesh, from the same weights through ``interop.from_jax``;
- K3/K4's plain distributed path against the plain single-process path on
  the concatenated rows (statistics and dx within 1e-5), the BN parameter
  gradients reduced exactly once, parameters and BN running buffers equal
  across ranks after a step, a batch-hard triplet step at world size 2
  against 1, and a video batch that needs pad rows.

Two process groups are spawned for the whole file (world 2 and world 4),
each check a part of one of them; each spawn has its own timeout, so a hung
collective fails the test instead of stalling the run.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.core.distributed import initialize, make_multihost_mesh
from deeplip_tpu_torch.core.mesh import make_mesh
from deeplip_tpu_torch.data.audio_io import write_wav
from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance, EvalUtteranceSet
from deeplip_tpu_torch.ops.cuda import bn_prelu as K
from deeplip_tpu_torch.ops.framing import samples_for_frames
from deeplip_tpu_torch.train.audio import AudioTrainer
from deeplip_tpu_torch.train.fusion import FusionTrainer
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 420
LOSS_TOL, PARAM_TOL, EMB_TOL, BN_TOL = 1e-4, 5e-4, 1e-5, 1e-5

MFCC = {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True, "normalize": True,
        "delta": False, "win_len": 0.025, "win_shift": 0.01}
AUDIO_DATA = {"rate": 16000, "feat_type": "mfcc", "mfcc": MFCC}
TDNN = {"input_dim": 24, "hidden_dim": [32, 32, 64],
        "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]], "tdnn_layers": 3,
        "embedding_dim": 16, "pooling": "statistic", "attention_hidden_size": 8,
        "bn_first": True}
# tests/test_distributed.py's TINY
TINY = {"data": {"frames": [40, 60], "python_data_config": AUDIO_DATA},
        "model": {"arch": "tdnn", "tdnn": TDNN},
        "train": {"type": "sgd", "bs": 16, "lr_decay": 0.1, "lr_decay_step": [100],
                  "epoch": 1, "loss": "LMCL", "scale": 30, "margin": [0.2, 0.2],
                  "sgd": {"init_lr": 0.05, "weight_decay": 1e-5, "momentum": 0.9}},
        "test": {}}
VIDEO_CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_dropout": 0.0,
             "tcn_dwpw": False, "tcn_kernel_size": [3], "tcn_num_layers": 1,
             "tcn_width_mult": 1, "width_mult": 1.0}
VIDEO_KW = dict(crop_size=(32, 32), hidden_dim=8, trunk_layers=(1, 1, 1, 1))
FUSION_AUDIO = {"arch": "tdnn", "tdnn": {**TDNN, "embedding_dim": 24}}
JAX_BS, JAX_T, JAX_N_SPK = 16, 60, 8


# ---------------------------------------------------------------- inputs
def _cfg(**train) -> Config:
    return Config({**TINY, "train": {**TINY["train"], **train}})


def _audio_batches(steps=3, bs=16, seed=0):
    rng = np.random.default_rng(seed)
    s = samples_for_frames(50, 0.025, 0.01, 16000)
    pcm = rng.standard_normal((steps, bs, s)).astype(np.float32)
    labels = rng.integers(0, 4, (steps, bs)).astype(np.int64)
    return pcm, labels


def _video_batch(rows=16, seed=3):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 255, (rows, 6, 40, 40)).astype(np.uint8)
    lengths = rng.integers(3, 7, rows).astype(np.int32)
    labels = rng.integers(0, 4, rows).astype(np.int64)
    return clips, lengths, labels


def _fusion_batch(rows=8, seed=4):
    rng = np.random.default_rng(seed)
    s = samples_for_frames(50, 0.025, 0.01, 16000)
    return {"pcm": rng.standard_normal((rows, s)).astype(np.float32),
            "clips": rng.integers(0, 255, (rows, 1, 6, 40, 40)).astype(np.uint8),
            "clip_lengths": np.full((rows, 1), 6, np.int32),
            "group_sizes": (np.arange(rows) % 3 != 2).astype(np.int32),
            "labels": rng.integers(0, 4, rows).astype(np.int64)}


def _bn_inputs(rows=16, c=8, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((rows, 3, c)) * 2 + 0.5, dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((rows, 3, c)), dtype=torch.float32)
    params = [torch.tensor(v, dtype=torch.float32) for v in (
        rng.uniform(0.5, 1.5, c), rng.normal(0, 0.2, c), rng.uniform(0.1, 0.3, c))]
    return x, dy, params


def _write_utterances(root: str, n=11, seed=6) -> list:
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(n):
        path = os.path.join(root, f"u{i:02d}.wav")
        write_wav(path, 0.1 * rng.standard_normal(int(16000 * rng.uniform(0.4, 0.9))), 16000)
        utts.append(EvalUtterance(f"u{i:02d}", path))
    return utts


def _eval_set(utts):
    return EvalUtteranceSet(utts, batch_size=5, num_workers=1)


# ---------------------------------------------------------------- runs
def _state(*modules) -> dict:
    return {f"{i}.{k}": v.detach().clone() for i, m in enumerate(modules)
            for k, v in m.state_dict().items()}


def _audio_run(mesh=None, steps=3, grouped=False) -> dict:
    """LMCL steps from PCM, single or as one group of ``steps`` (on the CPU
    a group runs its steps eagerly, all-reduces included)."""
    tr = AudioTrainer(_cfg(steps_per_dispatch=steps if grouped else 1), device="cpu",
                      n_spk=4, mesh=mesh)
    pcm, labels = _audio_batches(steps)
    rows = tr.mesh.rows(pcm.shape[1])
    pcm, labels = torch.tensor(pcm[:, rows]), torch.tensor(labels[:, rows])
    if grouped:
        losses = [float(v) for v in tr.train_group(pcm, labels, 0.2)["loss"]]
    else:
        losses = [float(tr.train_step(pcm[k], labels[k], 0.2)["loss"]) for k in range(steps)]
    return {"losses": losses, "model": _state(tr.model),
            "criterion": tr.criterion_state_dict()}


def _jax_feats():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((3, JAX_BS, JAX_T, 24)).astype(np.float32)
    labels = rng.integers(0, JAX_N_SPK, (3, JAX_BS)).astype(np.int64)
    return feats, labels


def _jax_cfg() -> dict:
    return {**TINY, "data": {**TINY["data"], "frames": [JAX_T, JAX_T]}}


def _feats_run(init: dict, mesh=None) -> dict:
    tr = AudioTrainer(Config(_jax_cfg()), device="cpu", n_spk=JAX_N_SPK, mesh=mesh)
    tr.model.load_state_dict(init["model"])
    tr.criterion.load_state_dict(init["criterion"])
    feats, labels = _jax_feats()
    rows = tr.mesh.rows(JAX_BS)
    losses = [float(tr.train_step_feats(torch.tensor(feats[k][rows]),
                                        torch.tensor(labels[k][rows]), 0.2)["loss"])
              for k in range(len(feats))]
    return {"losses": losses, "model": _state(tr.model),
            "criterion": tr.criterion_state_dict()}


def _triplet_run(mesh=None) -> dict:
    tr = AudioTrainer(_cfg(loss="Triplet", triplet_strategy="hardest"), device="cpu",
                      n_spk=4, mesh=mesh)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 16, 50, 24)).astype(np.float32)
    labels = np.tile(np.arange(4), (2, 4)).astype(np.int64)
    rows = tr.mesh.rows(16)
    losses = [float(tr.train_step_feats(torch.tensor(feats[k][rows]),
                                        torch.tensor(labels[k][rows]), 0.2)["loss"])
              for k in range(2)]
    return {"losses": losses, "model": _state(tr.model)}


def _video_trainer(mesh=None) -> VideoTrainer:
    """The video steps run in float64: Adam turns the sign of a gradient
    near zero into a whole step of the rate, so in f32 the order of a sum
    alone moves a few weights by two rates (6e-4) within two steps."""
    tr = VideoTrainer(VIDEO_CFG, num_classes=4, device="cpu", mesh=mesh, **VIDEO_KW)
    tr.model.to(torch.float64)
    return tr


def _video_run(mesh=None, rows=16, steps=2) -> dict:
    tr = _video_trainer(mesh)
    clips, lengths, labels = _video_batch(rows)
    batch = tr.pad_to_ranks({"clips": clips, "lengths": lengths, "labels": labels})
    gen = torch.Generator().manual_seed(7)
    losses, grads = [], None
    for _ in range(steps):
        m = tr.train_step(*(torch.from_numpy(batch[k]) for k in ("clips", "lengths", "labels")),
                          gen)
        losses.append(float(m["loss"]))
        if grads is None:   # the first step's reduced gradients of the K3/K4 sites
            grads = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
                     if "bn1" in n}
    return {"losses": losses, "model": _state(tr.model), "grads": grads,
            "rows": len(batch["labels"])}


def _fusion_run(mesh=None, rows=8, steps=2) -> dict:
    tr = FusionTrainer(FUSION_AUDIO, VIDEO_CFG, n_spk=4, audio_data_opts=AUDIO_DATA,
                       device="cpu", mesh=mesh, lr=0.05, steps_per_epoch=4,
                       video_hidden_dim=8, video_trunk_layers=(1, 1, 1, 1), crop_size=(32, 32))
    batch = tr.rank_rows(_fusion_batch(rows))
    keys = ("pcm", "clips", "clip_lengths", "group_sizes", "labels")
    losses = [float(tr.train_step(*(torch.from_numpy(batch[k]) for k in keys))["loss"])
              for _ in range(steps)]
    return {"losses": losses, "head": _state(tr.fusion_head, tr.criterion)}


def _embed_run(utts, mesh=None) -> dict:
    tr = AudioTrainer(_cfg(), device="cpu", n_spk=4, mesh=mesh)
    store = tr.extract_embeddings(_eval_set(utts))
    return {u.name: store[u.name].detach().clone() for u in utts}


def _bn_run(mesh=None) -> dict:
    x, dy, (scale, bias, alpha) = _bn_inputs()
    group = None
    if mesh is not None:
        rows = mesh.rows(len(x))
        x, dy, group = x[rows], dy[rows], mesh.data_group
    y, mean, var, inv = K.bn_prelu_forward(x, scale, bias, alpha, 1e-5, group)
    dx, dscale, dbias, dalpha = K.bn_prelu_backward(x, dy, mean, inv, scale, bias, alpha,
                                                    group)
    return {"y": y, "mean": mean, "var": var, "dx": dx,
            "param_grads": torch.stack([dscale, dbias, dalpha])}


# ---------------------------------------------------------------- groups
def _load(root: str, name: str):
    """A file this test wrote (plain objects beside the tensors)."""
    return torch.load(os.path.join(root, name), weights_only=False)


def _world2(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    initialize(f"file://{root}/store2", num_processes=2, process_id=rank, device="cpu")
    mesh = make_mesh()
    out = {"audio": _audio_run(mesh), "audio_grouped": _audio_run(mesh, grouped=True),
           "video": _video_run(mesh),
           "video_pad": _video_run(mesh, rows=15, steps=1),
           "fusion": _fusion_run(mesh), "fusion_pad": _fusion_run(mesh, rows=7),
           "triplet": _triplet_run(mesh), "bn": _bn_run(mesh),
           "feats": _feats_run(_load(root, "jax_init.pt"), mesh),
           "embeddings": _embed_run(_load(root, "utts.pt"), mesh)}
    dcn = make_multihost_mesh(local_size=1)
    out["dcn"] = {"shape": dcn.shape, "axes": dcn.axis_names,
                  "losses": _audio_run(dcn, steps=1)["losses"]}
    torch.save(out, os.path.join(root, f"world2_rank{rank}.pt"))


def _world4(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    initialize(f"file://{root}/store4", num_processes=4, process_id=rank, device="cpu")
    tp = make_mesh([("data", 2), ("model", 2)])
    dp = make_mesh([("data", 4)])
    tr = AudioTrainer(_cfg(), device="cpu", n_spk=4, mesh=tp)
    shard = {"rows": tuple(tr.criterion.weights.shape), "offset": tr._class_offset}
    torch.save({"tp": _audio_run(tp), "dp": _audio_run(dp), "shard": shard},
               os.path.join(root, f"world4_rank{rank}.pt"))


def _entry(rank: int, fn, root: str) -> None:
    try:
        fn(rank, root)
    except BaseException:
        import traceback
        with open(os.path.join(root, f"error_rank{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _spawn(fn, world: int, root: str, tag: str) -> list:
    """Run ``fn(rank, root)`` in ``world`` processes; fail on an error, or
    when they are not done within ``SPAWN_TIMEOUT_S``."""
    ctx = mp.spawn(_entry, args=(fn, root), nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the {tag} process group did not finish in {SPAWN_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        errors = [open(os.path.join(root, f)).read() for f in sorted(os.listdir(root))
                  if f.startswith("error_rank")]
        pytest.fail(f"the {tag} process group failed:\n{exc}\n" + "\n".join(errors))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [_load(root, f"{tag}_rank{r}.pt") for r in range(world)]


def _jax_pair(root: str) -> None:
    """The JAX trainer's init for the feature steps, written in the port's
    layout (``interop.from_jax``) for the spawned ranks."""
    import jax
    import jax.numpy as jnp

    from deeplip_tpu.core.config import Config as JaxConfig
    from deeplip_tpu.train.audio import AudioTrainer as JaxAudioTrainer
    from deeplip_tpu_torch.interop.from_jax import criterion_state_dict, speaker_embnet_state_dict

    jtr = JaxAudioTrainer(JaxConfig(_jax_cfg()), n_spk=JAX_N_SPK,
                          exp_root=os.path.join(root, "jax"))
    state = jtr.ensure_state()
    tree = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "stats": state.batch_stats})
    torch.save({"model": speaker_embnet_state_dict(tree["params"]["model"],
                                                   tree["stats"]["model"]),
                "criterion": criterion_state_dict(tree["params"]["criterion"])},
               os.path.join(root, "jax_init.pt"))
    del jnp


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world2"))
    _jax_pair(root)
    utts = _write_utterances(root)
    torch.save(utts, os.path.join(root, "utts.pt"))
    return {"root": root, "utts": utts, "ranks": _spawn(_world2, 2, root, "world2")}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world4"))
    return _spawn(_world4, 4, root, "world4")


# ---------------------------------------------------------------- checks
def _close_states(got: dict, want: dict, tol: float = PARAM_TOL) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


def _close_run(got: dict, want: dict, keys) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_TOL)
    for key in keys:
        _close_states(got[key], want[key])


@pytest.mark.parametrize("run", ["audio", "audio_grouped"])
def test_audio_step_world2_matches_one_process(world2, run):
    """Three LMCL steps from PCM, single and as one group of three."""
    want = _audio_run()
    for rank in world2["ranks"]:
        _close_run(rank[run], want, ("model", "criterion"))


def test_params_and_running_buffers_equal_across_ranks(world2):
    r0, r1 = world2["ranks"]
    for run, keys in (("audio", ("model", "criterion")), ("video", ("model",)),
                      ("fusion", ("head",)), ("triplet", ("model",))):
        assert r0[run]["losses"] == r1[run]["losses"], run
        for key in keys:
            for name, v in r0[run][key].items():
                assert torch.equal(v, r1[run][key][name]), (run, name)
    assert any("running_var" in n for n in r0["video"]["model"])
    assert any("running_var" in n for n in r0["audio"]["model"])


def test_video_step_world2_matches_one_process(world2):
    want = _video_run()
    for rank in world2["ranks"]:
        _close_run(rank["video"], want, ("model",))


def test_video_batch_with_pad_rows(world2):
    """15 rows pad to 16 over two ranks: the pad row (row 0's pixels and
    label, length 0, on rank 1) leaves the loss, and its frames are masked
    with row 0's length, not rank 1's first row's; one process on the same
    padded batch takes the same step."""
    clips, lengths, labels = _video_batch(15)
    assert lengths[0] != lengths[8]
    padded = _video_trainer()
    batch = {"clips": np.concatenate([clips, clips[:1]]),
             "lengths": np.concatenate([lengths, [0]]).astype(np.int32),
             "labels": np.concatenate([labels, labels[:1]])}
    gen = torch.Generator().manual_seed(7)
    m = padded.train_step(*(torch.from_numpy(batch[k]) for k in ("clips", "lengths", "labels")),
                          gen)
    want = {"losses": [float(m["loss"])], "model": _state(padded.model)}
    for rank in world2["ranks"]:
        assert rank["video_pad"]["rows"] == 16
        _close_run(rank["video_pad"], want, ("model",))


def test_bn_parameter_gradients_reduced_once(world2):
    """After one video step the K3/K4 sites' parameter gradients equal one
    process's: the local sums K4 returns are reduced by the one gradient
    all-reduce alone (a second reduction would double them)."""
    want = _video_run(steps=1)["grads"]
    assert want
    for rank in world2["ranks"]:
        for name, g in want.items():
            np.testing.assert_allclose(rank["video"]["grads"][name].numpy(), g.numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_plain_k3_k4_distributed_path_matches_concatenated_rows(world2):
    want = _bn_run()
    halves = [r["bn"] for r in world2["ranks"]]
    for key in ("mean", "var"):
        for h in halves:
            np.testing.assert_allclose(h[key].numpy(), want[key].numpy(), atol=BN_TOL,
                                       rtol=BN_TOL)
    for key in ("y", "dx"):
        got = torch.cat([h[key] for h in halves])
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), atol=BN_TOL, rtol=BN_TOL)
    # each rank's parameter sums are its own rows'; their sum is the whole
    total = halves[0]["param_grads"] + halves[1]["param_grads"]
    np.testing.assert_allclose(total.numpy(), want["param_grads"].numpy(), atol=BN_TOL,
                               rtol=BN_TOL)
    assert not torch.allclose(halves[0]["param_grads"], want["param_grads"])


def test_fusion_step_world2_matches_one_process(world2):
    want = _fusion_run()
    for rank in world2["ranks"]:
        _close_run(rank["fusion"], want, ("head",))


def test_fusion_zero_row_padding(world2):
    """7 rows pad to 8 with a zero row of group size 0: the loss over the
    all-reduced count of rows with clips is one process's on the 7 rows."""
    want = _fusion_run(rows=7)
    for rank in world2["ranks"]:
        _close_run(rank["fusion_pad"], want, ("head",))


def test_triplet_batch_hard_step_world2_matches_one_process(world2):
    want = _triplet_run()
    for rank in world2["ranks"]:
        _close_run(rank["triplet"], want, ("model",))


def test_embeddings_equal_across_world_sizes(world2):
    """Batches of 5 pad to 6 (zero PCM, length 1); each rank embeds its rows
    and every rank holds every embedding."""
    want = _embed_run(world2["utts"])
    for rank in world2["ranks"]:
        assert set(rank["embeddings"]) == set(want)
        for name, v in want.items():
            np.testing.assert_allclose(rank["embeddings"][name].numpy(), v.numpy(),
                                       atol=EMB_TOL, err_msg=name)


def test_two_process_dcn_mesh_train_step(world2):
    r0, r1 = world2["ranks"]
    assert r0["dcn"]["shape"] == (2, 1) and r0["dcn"]["axes"] == ("dcn", "data")
    assert np.isfinite(r0["dcn"]["losses"][0])
    assert r0["dcn"]["losses"] == r1["dcn"]["losses"]
    np.testing.assert_allclose(r0["dcn"]["losses"], _audio_run(steps=1)["losses"],
                               atol=LOSS_TOL)


def test_world2_audio_step_matches_jax_two_device_mesh(world2):
    """Three f32 LMCL feature steps: the port at world size 2 against the JAX
    ``AudioTrainer`` on a 2-device mesh, from the JAX init."""
    import jax
    import jax.numpy as jnp

    from deeplip_tpu.core.config import Config as JaxConfig
    from deeplip_tpu.core.mesh import data_sharding, make_mesh as jax_mesh
    from deeplip_tpu.interop.torch_export import (export_criterion_state_dict,
                                                  export_speaker_embnet_state_dict)
    from deeplip_tpu.train.audio import AudioTrainer as JaxAudioTrainer

    mesh = jax_mesh([("data", 2)], devices=jax.devices()[:2])
    jtr = JaxAudioTrainer(JaxConfig(_jax_cfg()), mesh=mesh, n_spk=JAX_N_SPK,
                          exp_root=os.path.join(world2["root"], "jax2"))
    state = jtr.ensure_state()
    feats, labels = _jax_feats()
    losses = []
    for k in range(len(feats)):
        state, m = jtr._train_step_feats(
            state, jax.device_put(feats[k], data_sharding(mesh, 3)),
            jax.device_put(labels[k], data_sharding(mesh, 1)), jnp.float32(0.2))
        losses.append(float(m["loss"]))
    tree = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "stats": state.batch_stats})
    want_model = export_speaker_embnet_state_dict(tree["params"]["model"],
                                                  tree["stats"]["model"])
    want_crit = export_criterion_state_dict(tree["params"]["criterion"])
    for rank in world2["ranks"]:
        got = rank["feats"]
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_TOL)
        for k, v in want_model.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got["model"][f"0.{k}"].numpy(), v, atol=PARAM_TOL,
                                       err_msg=k)
        for k, v in want_crit.items():
            np.testing.assert_allclose(got["criterion"][k].numpy(), v, atol=PARAM_TOL,
                                       err_msg=k)


def test_tensor_parallel_classifier_matches_data_parallel(world4):
    """(data 2, model 2): each rank holds 2 of the 4 classes' rows, and its
    steps reproduce pure data parallel over 4 ranks and one process."""
    want = _audio_run()
    for rank in world4:
        assert rank["shard"]["rows"] == (2, 16)
        _close_run(rank["tp"], rank["dp"], ("model", "criterion"))
        _close_run(rank["tp"], want, ("model", "criterion"))
    assert [r["shard"]["offset"] for r in world4] == [0, 2, 0, 2]
