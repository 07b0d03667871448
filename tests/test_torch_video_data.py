"""The port's video data path against the JAX package's: the clip transforms
(bit-equal, given the same crop offsets and flips), the bucketed clip
batches (bit-equal), and clip extraction from the same weights (1e-4); plus
one epoch of the port's trainer on a tiny corpus."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.data import video_dataset as JD
from deeplip_tpu.ops import video as JV
from deeplip_tpu.train import state as JState
from deeplip_tpu.train.video import VideoTrainer as JaxVideoTrainer
from deeplip_tpu_torch.data import video_dataset as PD
from deeplip_tpu_torch.interop.from_jax import lipreading_state_dict
from deeplip_tpu_torch.ops import video as PV
from deeplip_tpu_torch.ops.cuda import launch_counts
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(1)

CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3, 5, 7],
       "tcn_num_layers": 2, "tcn_dropout": 0.0, "tcn_dwpw": False, "tcn_width_mult": 1,
       "width_mult": 1.0}
SMALL = dict(crop_size=(32, 32), hidden_dim=8, trunk_layers=(1, 1, 1, 1))


def _clips(seed=0, shape=(4, 6, 40, 36)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- transforms
def test_crops_flips_and_affine_bit_equal():
    clips = _clips()
    jc, pc = jnp.asarray(clips), torch.from_numpy(clips)
    _eq(PV.center_crop(pc, (32, 32)), JV.center_crop(jc, (32, 32)))
    key = jax.random.PRNGKey(3)
    kh, kw = jax.random.split(key)
    dh = np.asarray(jax.random.randint(kh, (4,), 0, 40 - 32 + 1))
    dw = np.asarray(jax.random.randint(kw, (4,), 0, 36 - 32 + 1))
    _eq(PV.crop_at(pc, (32, 32), dh, dw), JV.random_crop(jc, (32, 32), key))
    flip = np.array(jax.random.bernoulli(key, 0.5, (4,)))
    _eq(PV.flip_at(pc, torch.from_numpy(flip)), JV.horizontal_flip(jc, key))
    every = torch.arange(256, dtype=torch.uint8)
    _eq(PV.normalize_pixels(every), JV.normalize_pixels(jnp.arange(256, dtype=jnp.uint8)))
    _eq(PV.eval_transform(pc, (32, 32)), JV.eval_transform(jc, (32, 32)))


def test_train_transform_bit_equal_given_the_draws():
    clips = _clips(1)
    key = jax.random.PRNGKey(5)
    kc, kf = jax.random.split(key)
    kh, kw = jax.random.split(kc)
    dh = np.asarray(jax.random.randint(kh, (4,), 0, 9))
    dw = np.asarray(jax.random.randint(kw, (4,), 0, 5))
    flip = torch.from_numpy(np.array(jax.random.bernoulli(kf, 0.5, (4,))))
    want = JV.train_transform(jnp.asarray(clips), key, (32, 32))
    _eq(PV.train_transform_at(torch.from_numpy(clips), dh, dw, flip, (32, 32)), want)


def test_train_transform_draws_from_its_generator():
    pc = torch.from_numpy(_clips(2))
    a = PV.train_transform(pc, torch.Generator().manual_seed(9), (32, 32))
    g = torch.Generator().manual_seed(9)
    dh, dw = PV.crop_offsets(pc, (32, 32), g)
    flip = PV.flip_flags(4, g)
    assert torch.equal(a, PV.train_transform_at(pc, dh, dw, flip, (32, 32)))
    assert a.dtype == torch.float32 and tuple(a.shape) == (4, 6, 32, 32)
    g = torch.Generator().manual_seed(4)
    dh, dw = PV.crop_offsets(pc, (32, 32), g)
    assert torch.equal(PV.random_crop(pc, (32, 32), torch.Generator().manual_seed(4)),
                       PV.crop_at(pc, (32, 32), dh, dw))
    flip = PV.flip_flags(4, torch.Generator().manual_seed(5))
    assert torch.equal(PV.horizontal_flip(pc, torch.Generator().manual_seed(5)),
                       PV.flip_at(pc, flip))


def test_mask_pad_frames_bit_equal():
    x = np.random.default_rng(3).standard_normal((4, 6, 5, 5, 1)).astype(np.float32)
    lengths = np.array([6, 2, 0, 4], np.int32)  # a length-0 row is left whole
    _eq(PV.mask_pad_frames(torch.from_numpy(x), torch.from_numpy(lengths)),
        JV.mask_pad_frames(jnp.asarray(x), jnp.asarray(lengths)))


# ---------------------------------------------------------------- batches
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 speakers x 5 clips of 3-11 frames, 40x36 uint8, npz and npy."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for s in range(4):
        os.makedirs(root / f"spk{s}")
        for c in range(5):
            data = rng.integers(0, 256, (int(rng.integers(3, 12)), 40, 36), dtype=np.uint8)
            if c == 4:
                np.save(root / f"spk{s}" / f"c{c}.npy", data[..., None])
            else:
                np.savez(root / f"spk{s}" / f"c{c}.npz", data=data)
    return str(root)


def test_scan_and_probe_match(corpus):
    want = JD.scan_clip_dir(corpus, label_list=["spk3", "spk2", "spk1", "spk0"])
    got = PD.scan_clip_dir(corpus, label_list=["spk3", "spk2", "spk1", "spk0"])
    assert [(c.path, c.label, c.name) for c in got] == [(c.path, c.label, c.name) for c in want]
    for c in got:
        assert PD._probe_clip_length(c.path) == JD._probe_clip_length(c.path)
        np.testing.assert_array_equal(PD.load_clip(c.path), JD.load_clip(c.path))


@pytest.mark.parametrize("kw", [dict(shuffle=True), dict(shuffle=False),
                                dict(shuffle=True, pre_crop=(32, 30)),
                                dict(shuffle=True, max_frames=7)])
def test_batches_bit_equal(corpus, kw):
    clips_j, clips_p = JD.scan_clip_dir(corpus), PD.scan_clip_dir(corpus)
    want_b = JD.VideoClipBatches(clips_j, batch_size=3, bucket_t=4, seed=2, **kw)
    got_b = PD.VideoClipBatches(clips_p, batch_size=3, bucket_t=4, seed=2, **kw)
    assert got_b.n_classes == want_b.n_classes == 4
    for epoch in (0, 1):
        want, got = list(want_b.epoch(epoch)), list(got_b.epoch(epoch))
        assert len(got) == len(want) > 4
        for g, w in zip(got, want):
            assert g["names"] == w["names"]
            for k in ("clips", "lengths", "labels"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------- extraction
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


def test_extraction_matches_jax(corpus, tmp_path):
    jtr = JaxVideoTrainer(JaxConfig(CFG), 4, exp_root=str(tmp_path / "jax"), **SMALL)
    variables = jax.jit(jtr.model.init)(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 2, 32, 32, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    _randomise(params, stats, np.random.default_rng(11))
    jtr.state = JState.TrainState(params=params, batch_stats=stats,
                                  opt_state=jtr.tx.init(params), step=0)
    ptr = VideoTrainer(CFG, 4, device="cpu", exp_root=str(tmp_path / "port"), **SMALL)
    ptr.model.load_state_dict(lipreading_state_dict(params, stats), strict=True)
    # one bucket of 12-frame batches, so the JAX side compiles one shape
    batches = dict(batch_size=20, bucket_t=12, shuffle=False, pre_crop=(32, 32))
    want = jtr.extract_clip_embeddings(JD.VideoClipBatches(JD.scan_clip_dir(corpus), **batches))
    got = ptr.extract_clip_embeddings(PD.VideoClipBatches(PD.scan_clip_dir(corpus), **batches))
    assert set(got) == set(want) and len(got) == 20
    for name, v in want.items():
        assert tuple(got[name].shape) == (512,)
        np.testing.assert_allclose(got[name].numpy(), v, atol=1e-4, rtol=1e-4, err_msg=name)
    store = ptr.embedding_store(PD.VideoClipBatches(PD.scan_clip_dir(corpus), **batches),
                                name_map=lambda n: n.split(os.sep)[0])
    assert len(store) == 4
    np.testing.assert_allclose(
        store["spk0"].numpy(),
        np.mean([v for n, v in want.items() if n.startswith("spk0")], axis=0), atol=1e-4)
    batch = next(iter(JD.VideoClipBatches(JD.scan_clip_dir(corpus), **batches).epoch(0)))
    np.testing.assert_allclose(
        ptr.classify_logits(torch.from_numpy(batch["clips"]),
                            torch.from_numpy(batch["lengths"])).numpy(),
        jtr.classify_logits(jnp.asarray(batch["clips"]), jnp.asarray(batch["lengths"])),
        atol=1e-4, rtol=1e-4)
    feats = ptr.extract_clip_features(
        PD.VideoClipBatches(PD.scan_clip_dir(corpus), **batches), out_root=str(tmp_path / "emb"))
    saved = np.load(tmp_path / "emb" / "spk1" / "c0.npz")["data"]
    assert saved.shape == (1,) + feats[os.path.join("spk1", "c0")].shape
    assert saved.shape[-1] == 512
    np.testing.assert_allclose(saved[0].mean(0), want[os.path.join("spk1", "c0")], atol=1e-4)


def test_one_epoch_of_training_on_the_cpu(corpus, tmp_path):
    tr = VideoTrainer(CFG, 4, device="cpu", exp_root=str(tmp_path), log_time="run", **SMALL)
    batches = PD.VideoClipBatches(PD.scan_clip_dir(corpus), batch_size=8, bucket_t=4)
    n_batches = len(list(batches.epoch(1)))
    counts = launch_counts()
    losses = tr.train(batches, epochs=1)
    assert launch_counts() == counts  # CPU tensors launch nothing
    assert len(losses) == n_batches == tr.step and all(np.isfinite(losses))
    assert os.path.exists(os.path.join(tr.exp_dir, "net_1"))
    assert os.path.exists(os.path.join(tr.exp_dir, "video_metrics.jsonl"))
    resumed = VideoTrainer(CFG, 4, device="cpu", exp_root=str(tmp_path), log_time="run",
                           seed=1, **SMALL)
    assert resumed.train(batches, epochs=1, auto_resume=True) == []
    assert resumed.current_epoch == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
