"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.core.config import AUDIO_DATA_OPTS, ETDNN_MODEL_OPTS, Config
from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList, cosine_eer
from deeplip_tpu_torch.eval.snorm import asnorm_trial_scores
from deeplip_tpu_torch.serve import AVSpeakerVerifier, ProfileVerifier, SpeakerVerifier
from deeplip_tpu_torch.train.audio import AudioExtractor, AudioTrainer
from deeplip_tpu_torch.train.fusion import FusionTrainer
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.path.insert(0, {repo!r})
    import deeplip_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        deeplip_tpu_torch.__path__, "deeplip_tpu_torch.")]
    for name in names + ["chip_smoke"]:
        importlib.import_module(name)
    audio_training = [
        "deeplip_tpu_torch.losses.softmax", "deeplip_tpu_torch.losses.triplet",
        "deeplip_tpu_torch.data.manifest", "deeplip_tpu_torch.data.sampler",
        "deeplip_tpu_torch.data.audio_pipeline", "deeplip_tpu_torch.train.schedules",
        "deeplip_tpu_torch.train.state", "deeplip_tpu_torch.train.checkpoint",
        "deeplip_tpu_torch.train.audio", "deeplip_tpu_torch.eval.plda",
        "deeplip_tpu_torch.cli.common", "deeplip_tpu_torch.cli.train_audio"]
    assert set(audio_training) <= set(names), sorted(set(audio_training) - set(names))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0].startswith("jax")
                 or m == "deeplip_tpu" or m.startswith("deeplip_tpu."))
    print(len(names), bad)
""")


def test_port_imports_no_jax_and_no_jax_package():
    # -I: an isolated interpreter, so nothing on PYTHONPATH or in a
    # sitecustomize can preload JAX behind the port's back
    out = subprocess.run(
        [sys.executable, "-I", "-c", _PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, check=True).stdout.split()
    n_modules, bad = int(out[0]), " ".join(out[1:])
    assert n_modules >= 40   # the serving and CLI modules among them
    assert bad == "[]", bad


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    cfg = Config({"model": ETDNN_MODEL_OPTS,
                  "data": {"python_data_config": AUDIO_DATA_OPTS}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioExtractor(cfg)
    store = EmbeddingStore()
    store["a"] = torch.ones(4)
    store["b"] = torch.ones(4)
    trials = TrialList(labels=np.array([1], np.int8), utt1=["a"], utt2=["b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cosine_eer(trials, store)
    video_cfg = {"backbone_type": "resnet", "relu_type": "prelu",
                 "tcn_kernel_size": [3, 5, 7], "tcn_num_layers": 1}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoTrainer(video_cfg, 4, hidden_dim=8, trunk_layers=(1, 1, 1, 1))
    # asked for the CPU, the same entry points run there
    assert AudioExtractor(cfg, device="cpu").device == torch.device("cpu")
    assert VideoTrainer(video_cfg, 4, device="cpu", hidden_dim=8,
                        trunk_layers=(1, 1, 1, 1)).device == torch.device("cpu")


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    audio_cfg = Config({"model": ETDNN_MODEL_OPTS,
                        "data": {"python_data_config": AUDIO_DATA_OPTS}})
    video_tcn = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3],
                 "tcn_num_layers": 1}
    fusion_cfg = Config({
        "data": {"python_data_config": AUDIO_DATA_OPTS},
        "model": {"audio_config": ETDNN_MODEL_OPTS, "video_config": {"tcn": video_tcn}},
        "train": {}, "test": {}})
    for build in (lambda **kw: SpeakerVerifier(audio_cfg, **kw),
                  lambda **kw: AVSpeakerVerifier(fusion_cfg, **kw),
                  lambda **kw: FusionTrainer(ETDNN_MODEL_OPTS, video_tcn, 2,
                                             audio_data_opts=AUDIO_DATA_OPTS, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    emb = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asnorm_trial_scores(emb, [[0, 1]], emb, top_k=2)
    big = ProfileVerifier()
    big.host_score_macs = 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        big._pair_scores(emb, [[0, 1]])
    # asked for the CPU, they run there
    assert SpeakerVerifier(audio_cfg, device="cpu").extractor.device == torch.device("cpu")
    assert asnorm_trial_scores(emb, [[0, 1]], emb, top_k=2, device="cpu").shape == (1,)


def test_audio_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from deeplip_tpu_torch.cli import train_audio

    _no_card(monkeypatch)
    cfg = Config({"model": ETDNN_MODEL_OPTS, "train": {"loss": "LMCL"},
                  "data": {"python_data_config": AUDIO_DATA_OPTS}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioTrainer(cfg, n_spk=4)
    path = tmp_path / "audio.json"
    path.write_text(json.dumps(cfg.to_dict()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_audio.main(["--config", str(path), "--mode", "test",
                          "--exp-root", str(tmp_path)])
    # asked for the CPU, they run there
    assert AudioTrainer(cfg, n_spk=4, device="cpu").device == torch.device("cpu")
