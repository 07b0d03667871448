"""The audio-visual serving path as a whole: the same seeded ``(wav,
clips)`` items through the JAX package's paired extraction and verifier and
through the port's, with the weights of both encoders and the head carried
across by ``interop.from_jax``.

Tolerances. The raw parts (audio x-vector, video group mean) are held to
the reference's embedding bar, 1e-4. The fused concat divides each half by
its own standard deviation, so an error of 1e-4 in a raw entry becomes
1e-4 / std there: the fused vector is held to ``PART_TOL / min(std)``,
computed from the JAX parts, and the head output (a gated copy of the raw
x-vector) to 1e-4 again.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.core.mesh import make_mesh
from deeplip_tpu.train import fusion as JT
from deeplip_tpu_torch.cli.train_fusion import extract_pairs, make_trainer
from deeplip_tpu_torch.core.config import Config, load_fusion_config
from deeplip_tpu_torch.data.audio_io import write_wav
from deeplip_tpu_torch.interop.from_jax import (lipreading_state_dict, lowfer_state_dict,
                                                speaker_embnet_state_dict)
from deeplip_tpu_torch.serve import AVSpeakerVerifier
from deeplip_tpu_torch.train.fusion import FusionTrainer, embed_av_items

torch.set_num_threads(1)
PART_TOL = 1e-4

DATA_OPTS = {"rate": 16000, "feat_type": "mfcc",
             "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
                      "normalize": True, "delta": False, "win_len": 0.025,
                      "win_shift": 0.01}}
AUDIO_MODEL = {"arch": "tdnn", "tdnn": {
    "input_dim": 24, "hidden_dim": [24, 24, 48],
    "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]], "tdnn_layers": 3,
    "embedding_dim": 16, "pooling": "statistic", "bn_first": True}}
VIDEO_TCN = {"extract_feats": True, "backbone_type": "resnet", "width_mult": 1.0,
             "relu_type": "prelu", "tcn_num_layers": 2, "tcn_kernel_size": [3, 5],
             "tcn_dropout": 0.2, "tcn_dwpw": False, "tcn_width_mult": 1}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def _randomise_bn(params, stats, rng):
    """Non-trivial BN parameters and running statistics, in place."""
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "bias" in sub and name in stats and "mean" in stats[name]:
            c = sub["scale"].shape
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            stats[name]["mean"] = rng.normal(0, 0.3, c).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        else:
            _randomise_bn(sub, stats.get(name, {}), rng)


def _carry(jax_trainer, port_trainer, seed):
    """Randomise the JAX trainer's BN state, then load its encoders and head
    into the port's trainer. The JAX video tree holds no TCN (the fusion
    stack never runs it), so the port keeps its own, equally unused."""
    rng = np.random.default_rng(seed)
    audio, video = _np_tree(jax_trainer.audio_vars), _np_tree(jax_trainer.video_vars)
    _randomise_bn(audio["params"], audio["batch_stats"], rng)
    _randomise_bn(video["params"], video["batch_stats"], rng)
    jax_trainer.audio_vars, jax_trainer.video_vars = audio, video
    jax_trainer._extract_fns = {}
    head = _np_tree(jax_trainer.ensure_state().params["fusion"])
    video_sd = lipreading_state_dict(video["params"], video["batch_stats"])
    assert not any(k.startswith("tcn.") for k in video_sd)
    port_trainer.load_state_dicts(
        audio=speaker_embnet_state_dict(audio["params"], audio["batch_stats"]),
        video={**port_trainer.video_model.state_dict(), **video_sd},
        head=lowfer_state_dict(head))


def _items(seed, size=48, big=56, frames=10):
    """Five items: ragged PCM, one or two clips of unequal length, one clip
    larger than the others, one item with an empty clip group."""
    rng = np.random.default_rng(seed)
    groups = [[(7, size), (frames, size)], [(frames, big)], [], [(5, size), (12, size)],
              [(9, size)]]
    items = []
    for i, group in enumerate(groups):
        pcm = (0.1 * rng.standard_normal(int(rng.integers(8000, 16000)))).astype(np.float32)
        clips = [rng.integers(0, 256, (t, s, s), dtype=np.uint8) for t, s in group]
        items.append((f"item{i}", pcm, clips))
    return items


@pytest.fixture(scope="module")
def trainers():
    kw = dict(audio_data_opts=DATA_OPTS, crop_size=(40, 40), video_hidden_dim=32,
              video_trunk_layers=(1, 1, 1, 1))
    video_cfg = {k: v for k, v in VIDEO_TCN.items() if k != "extract_feats"}
    jt = JT.FusionTrainer(JaxConfig(AUDIO_MODEL), JaxConfig(video_cfg), n_spk=4,
                          mesh=make_mesh(), **kw)
    jt.init_encoders()
    pt = FusionTrainer(Config(AUDIO_MODEL), video_cfg, n_spk=4, device="cpu", **kw)
    _carry(jt, pt, seed=1)
    return jt, pt


def test_embed_av_items_match(trainers):
    jt, pt = trainers
    items = _items(seed=2)
    kw = dict(max_clips=2, clip_frames=10, chunk_size=3)
    names = [n for n, _, _ in items]

    want_a, want_v = JT.embed_av_items(jt, items, return_parts=True, **kw)
    got_a, got_v = embed_av_items(pt, items, return_parts=True, **kw)
    for n in names:
        np.testing.assert_allclose(got_a[n].numpy(), want_a[n], rtol=0, atol=PART_TOL)
        np.testing.assert_allclose(got_v[n].numpy(), want_v[n], rtol=0, atol=PART_TOL)
    # the empty group divides by max(0, 1): a zero video embedding, in both
    assert not got_v["item2"].any() and not want_v["item2"].any()

    want = JT.embed_av_items(jt, items, **kw)
    got = embed_av_items(pt, items, **kw)
    for n in (m for m in names if m != "item2"):
        stds = min(float(want_a[n].std()), float(want_v[n].std()))
        assert got[n].shape == want[n].shape == (16 + 512,)
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=0, atol=PART_TOL / stds,
                                   err_msg=n)
    # z-norm of the all-zero video half is 0/0 in both packages
    assert np.isnan(want["item2"][16:]).all() and torch.isnan(got["item2"][16:]).all()
    np.testing.assert_allclose(got["item2"][:16].numpy(), want["item2"][:16], rtol=0,
                               atol=PART_TOL / float(want_a["item2"].std()))

    want_h = JT.embed_av_items(jt, items, use_fusion_head=True, **kw)
    got_h = embed_av_items(pt, items, use_fusion_head=True, **kw)
    for n in names:
        assert got_h[n].shape == want_h[n].shape == (3 * 16,)
        np.testing.assert_allclose(got_h[n].numpy(), want_h[n], rtol=0, atol=PART_TOL,
                                   err_msg=n)


def test_batched_group_embed_equals_the_per_clip_loop(trainers):
    _, pt = trainers
    rng = np.random.default_rng(3)
    lengths = np.array([[6, 10], [10, 0], [0, 0]], np.int32)
    sizes = np.array([2, 1, 0], np.int32)
    clips = np.zeros((3, 2, 10, 40, 40), np.uint8)
    for b in range(3):
        for g in range(2):
            clips[b, g, :lengths[b, g]] = rng.integers(0, 256, (lengths[b, g], 40, 40))
    as_t = torch.from_numpy
    with torch.no_grad():
        got = pt._video_group_embed(as_t(clips), as_t(lengths), as_t(sizes)).numpy()
        alone = [[pt._video_group_embed(as_t(clips[b:b + 1, g:g + 1, :lengths[b, g]]),
                                        as_t(lengths[b:b + 1, g:g + 1]),
                                        torch.ones(1, dtype=torch.int32)).numpy()[0]
                  for g in range(sizes[b])] for b in range(3)]
    # each clip alone, unpadded, at batch 1: zeroed pad frames and masked
    # means make the dense batch the same function; f32 rounding only
    np.testing.assert_allclose(got[0], np.mean(alone[0], axis=0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], alone[1][0], rtol=0, atol=1e-5)
    assert not got[2].any()


def test_clip_smaller_than_the_crop_raises(trainers):
    _, pt = trainers
    item = ("x", np.zeros(8000, np.float32), [np.zeros((4, 36, 48), np.uint8)])
    with pytest.raises(ValueError, match="smaller than the eval crop"):
        embed_av_items(pt, [item], clip_frames=10)


# ---------------------------------------------------------------- the verifier
def _write_av_corpus(root, n_spk=3, per=3, seed=4):
    """Wavs under ``root/audio`` and one or two 96x96 clips per utterance
    under ``root/video``; returns the fusion config (a dict), the trial list
    path and ``{speaker: [(wav, clips), ...]}``."""
    rng = np.random.default_rng(seed)
    items, names = {}, []
    for s in range(n_spk):
        os.makedirs(os.path.join(root, "audio", f"s{s:02d}"))
        os.makedirs(os.path.join(root, "video", f"s{s:02d}"))
        for u in range(per):
            n = int(rng.integers(9000, 14000))
            t = np.arange(n) / 16000.0
            y = (0.3 * np.sin(2 * np.pi * (110 + 45 * s) * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
                 + 0.03 * rng.standard_normal(n)).astype(np.float32)
            name = f"s{s:02d}/u{u}.wav"
            write_wav(os.path.join(root, "audio", name), y, 16000)
            clips = []
            for c in range(1 + (u % 2)):
                base = rng.integers(0, 256, (1, 96, 96)) * 0.5 + 40 * s
                frames = base + rng.normal(0, 20, (int(rng.integers(3, 6)), 96, 96))
                path = os.path.join(root, "video", f"s{s:02d}", f"u{u}_{c}.npz")
                np.savez(path, data=np.clip(frames, 0, 255).astype(np.uint8))
                clips.append(path)
            items.setdefault(f"s{s:02d}", []).append((os.path.join(root, "audio", name), clips))
            names.append(name)
    trial_path = os.path.join(root, "trials.txt")
    with open(trial_path, "w") as f:
        for a in range(len(names)):
            for b in range(a + 1, len(names)):
                f.write(f"{int(names[a][:3] == names[b][:3])} {names[a]} {names[b]}\n")
    cfg = {
        "data": {"video_root": os.path.join(root, "video"),
                 "test_root": os.path.join(root, "audio"), "trial_grid": trial_path,
                 "python_data_config": DATA_OPTS},
        "model": {"audio_config": AUDIO_MODEL,
                  "video_config": {"arch": "tcn", "tcn": dict(VIDEO_TCN, tcn_num_layers=1,
                                                             tcn_kernel_size=[3])}},
        "train": {"max_clips": 2, "clip_frames": 5, "resume": "None", "n_spk": 3,
                  "audio_config": {"resume": "None"}, "video_config": {"resume": "None"}},
        "test": {"use_cos": True, "use_fusion_head": False},
    }
    return cfg, trial_path, items


@pytest.fixture(scope="module")
def verifiers(tmp_path_factory):
    from deeplip_tpu.serve import AVSpeakerVerifier as JaxAVSpeakerVerifier

    root = str(tmp_path_factory.mktemp("av_corpus"))
    cfg, trial_path, items = _write_av_corpus(root)
    cfg_path = os.path.join(root, "fusion.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    jv = JaxAVSpeakerVerifier(JaxConfig(cfg), exp_root=os.path.join(root, "exp"),
                              log_time="jax")
    pv = AVSpeakerVerifier(cfg_path, exp_root=os.path.join(root, "exp"), log_time="port",
                           device="cpu")
    _carry(jv.trainer, pv.trainer, seed=5)
    return jv, pv, trial_path, items


def test_av_verifier_matches_jax(verifiers):
    jv, pv, trial_path, items = verifiers
    want_eer, want_thr = jv.calibrate(trial_path)
    got_eer, got_thr = pv.calibrate(trial_path)
    assert got_thr == pytest.approx(want_thr, abs=1e-4) and pv.threshold == got_thr
    assert got_eer == pytest.approx(want_eer, abs=1e-6)

    for spk, its in items.items():
        want_p = jv.enroll(spk, its[:2])
        got_p = pv.enroll(spk, its[:2])
        assert isinstance(got_p, np.ndarray) and got_p.dtype == np.float32
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-4)

    margins = []
    for claimed in items:
        for spk, its in items.items():
            probe = its[2]
            want, got = jv.verify(claimed, probe), pv.verify(claimed, probe)
            assert got.score == pytest.approx(want.score, abs=1e-4)
            assert got.accept == want.accept and got.threshold == pv.threshold
            margins.append(abs(want.score - want_thr))
            want_rank, got_rank = jv.identify(probe, top_k=3), pv.identify(probe, top_k=3)
            assert [n for n, _ in got_rank] == [n for n, _ in want_rank]
            np.testing.assert_allclose([s for _, s in got_rank], [s for _, s in want_rank],
                                       rtol=0, atol=1e-4)
    # equal decisions are a fair demand only off the threshold: no score of
    # this corpus sits within 1e-3 of it
    assert min(margins) > 1e-3


def test_av_verifier_paths_equal_arrays_and_use_the_head(verifiers):
    _, pv, _, items = verifiers
    wav, clips = items["s00"][1]
    from deeplip_tpu_torch.data.audio_io import read_wav

    in_memory = (read_wav(wav)[0], [np.load(c)["data"] for c in clips])
    a = pv.embed_items({"x": (wav, clips)})["x"]
    b = pv.embed_items({"x": in_memory})["x"]
    assert torch.equal(a, b) and a.shape == (16 + 512,)
    pv.use_fusion_head = True
    try:
        assert pv.embed_items({"x": in_memory})["x"].shape == (48,)
    finally:
        pv.use_fusion_head = False


def test_make_trainer_and_extract_pairs(verifiers, tmp_path):
    _, pv, trial_path, _ = verifiers
    cfg = load_fusion_config(os.path.join(os.path.dirname(trial_path), "fusion.json"))
    names = ["s00/u0.wav", "s01/u1.wav"]
    fused = extract_pairs(pv.trainer, cfg, names)
    audio, video = extract_pairs(pv.trainer, cfg, names, return_parts=True)
    assert fused["s01/u1.wav"].shape == (528,) and audio["s00/u0.wav"].shape == (16,)
    assert video["s01/u1.wav"].shape == (512,)

    # checkpoints named by the config are loaded; a missing one raises
    path = str(tmp_path / "net_audio")
    torch.save({"epoch": 3, "state_dict": pv.trainer.audio_model.state_dict()}, path)
    cfg.train["audio_config"]["resume"] = path
    loaded = make_trainer(cfg, str(tmp_path), "t", mode="av_test", device="cpu")
    for k, v in pv.trainer.audio_model.state_dict().items():
        assert torch.equal(loaded.audio_model.state_dict()[k], v), k
    cfg.train["video_config"]["resume"] = str(tmp_path / "no_such_checkpoint")
    with pytest.raises(FileNotFoundError, match="video encoder checkpoint not found"):
        make_trainer(cfg, str(tmp_path), "t", mode="av_test", device="cpu")
    # train mode builds the trainer too (fusion training is ported); it
    # loads the encoders but not the head a train.resume names
    cfg.train["video_config"]["resume"] = "None"
    head = str(tmp_path / "net_head")
    moved = {k: v + 1.0 if v.is_floating_point() else v
             for k, v in pv.trainer.fusion_head.state_dict().items()}
    torch.save({"epoch": 3, "state_dict": moved}, head)
    cfg.train["resume"] = head
    trained = make_trainer(cfg, str(tmp_path), "t", mode="train", device="cpu")
    assert trained.current_epoch == 0 and trained.manifest is None
    assert not torch.equal(trained.fusion_head.state_dict()["U"], moved["U"])
    for k, v in pv.trainer.audio_model.state_dict().items():
        assert torch.equal(trained.audio_model.state_dict()[k], v), k
    resumed = make_trainer(cfg, str(tmp_path), "t", mode="av_test", device="cpu")
    assert resumed.current_epoch == 3 and torch.equal(resumed.fusion_head.U, moved["U"])


def test_fusion_config_loads_and_the_card_check_carries_its_sections(tmp_path):
    """``load_fusion_config`` reads the repo's fusion config as the JAX
    package's loader does, and the card check's phase-10 config is that
    file with only its paths, resume keys, speaker count and test switches
    set (it loads the file itself: the port reads YAML without pyyaml)."""
    import chip_smoke
    from deeplip_tpu.core.config import load_fusion_config as jax_load_fusion_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "conf", "fusion_config.yaml")
    cfg = load_fusion_config(path)
    assert cfg.to_dict() == jax_load_fusion_config(path).to_dict()
    assert cfg.model.audio_config.etdnn.embedding_dim == 512 and cfg.train.max_clips == 2
    assert not hasattr(chip_smoke, "FUSION_MODEL") and not hasattr(chip_smoke, "FUSION_TEST")
    card = load_fusion_config(chip_smoke.fusion_config(str(tmp_path), {"audio": "a"}, True))
    assert card.model.to_dict() == cfg.model.to_dict()
    assert card.data.python_data_config.to_dict() == cfg.data.python_data_config.to_dict()
    assert {k: v for k, v in card.test.items() if k != "batch_size"} \
        == dict(cfg.test.to_dict(), use_fusion_head=True)
    assert card.test.use_fusion_head is True and card.train.audio_config.resume == "a"
    for key in ("bs", "max_clips", "clip_frames", "sgd", "loss", "lr_decay_step"):
        assert card.train[key] == cfg.train[key], key


def test_fusion_config_fills_missing_sections(tmp_path):
    path = tmp_path / "f.json"
    path.write_text(json.dumps({"model": {"a": 1}, "test": None}))
    cfg = load_fusion_config(str(path))
    assert cfg.test == {} and cfg.data == {} and cfg.train == {} and cfg.model.a == 1
