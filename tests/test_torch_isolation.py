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
    fusion_and_video = [
        "deeplip_tpu_torch.core.yaml_subset", "deeplip_tpu_torch.data.fusion_pipeline",
        "deeplip_tpu_torch.data.video_io", "deeplip_tpu_torch.cli.train_fusion",
        "deeplip_tpu_torch.cli.train_video"]
    assert set(fusion_and_video) <= set(names), sorted(set(fusion_and_video) - set(names))
    dispatch_and_interop = [
        "deeplip_tpu_torch.train.dispatch", "deeplip_tpu_torch.interop.torch_import",
        "deeplip_tpu_torch.interop.torch_export", "deeplip_tpu_torch.cli.export_torch"]
    assert set(dispatch_and_interop) <= set(names), sorted(
        set(dispatch_and_interop) - set(names))
    variants = [
        "deeplip_tpu_torch.models.shufflenetv2", "deeplip_tpu_torch.models.audio_resnet",
        "deeplip_tpu_torch.models.pooling", "deeplip_tpu_torch.models.tcn"]
    assert set(variants) <= set(names), sorted(set(variants) - set(names))
    kaldi_and_host_io = [
        "deeplip_tpu_torch.interop.kaldi", "deeplip_tpu_torch.data.kaldi_dataset",
        "deeplip_tpu_torch.cli.kaldi_xv", "deeplip_tpu_torch.native",
        "deeplip_tpu_torch.train.tb_events", "deeplip_tpu_torch.train.flops",
        "deeplip_tpu_torch.data.synthetic"]
    assert set(kaldi_and_host_io) <= set(names), sorted(set(kaldi_and_host_io) - set(names))
    multi_gpu = ["deeplip_tpu_torch.core.mesh", "deeplip_tpu_torch.core.distributed"]
    assert set(multi_gpu) <= set(names), sorted(set(multi_gpu) - set(names))
    verification = [
        "deeplip_tpu_torch.cli.parity_check", "deeplip_tpu_torch.cli.prepare_data",
        "deeplip_tpu_torch.examples.full_pipeline_demo",
        "deeplip_tpu_torch.examples.verify_demo"]
    assert set(verification) <= set(names), sorted(set(verification) - set(names))
    research = [
        "deeplip_tpu_torch.cli.convergence_study",
        "deeplip_tpu_torch.cli.convergence_video_study",
        "deeplip_tpu_torch.cli.convergence_fusion_study",
        "deeplip_tpu_torch.cli.resample_study"]
    assert set(research) <= set(names), sorted(set(research) - set(names))
    # they keep their own copies of what they need from the repo's scripts
    # and from __graft_entry__
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "scripts", "benchmarks", "examples", "__graft_entry__"))
    assert not foreign, foreign
    # importing builds nothing: the native library is built at its first call
    native = sys.modules["deeplip_tpu_torch.native"]
    assert native._lib is None and native._error is None
    # and starts no process group
    import torch.distributed
    assert not torch.distributed.is_initialized()
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


_SURFACES = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import deeplip_tpu_torch.core, deeplip_tpu_torch.data, deeplip_tpu_torch.eval
    import deeplip_tpu_torch.interop, deeplip_tpu_torch.losses, deeplip_tpu_torch.models
    import deeplip_tpu_torch.ops
    packages = set("deeplip_tpu_torch." + p for p in
                   ("core", "data", "eval", "interop", "losses", "models", "ops"))
    loaded = sorted(m for m in sys.modules
                    if m.startswith("deeplip_tpu_torch.") and m not in packages)
    # the re-exports resolve at first use: no builder, no module behind them
    from deeplip_tpu_torch.ops import extract_features, masked_mean
    from deeplip_tpu_torch.core import make_mesh, initialize
    import torch.distributed
    builders = [m for m in ("deeplip_tpu_torch.ops.cuda.build", "deeplip_tpu_torch.native")
                if m in sys.modules and getattr(sys.modules[m], "_lib", None) is not None]
    print(loaded, builders, torch.distributed.is_initialized())
""")


def test_package_surfaces_import_nothing_eagerly():
    out = subprocess.run(
        [sys.executable, "-I", "-c", _SURFACES.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    assert out.strip() == "[] [] False", out


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


def test_fusion_and_video_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The fusion trainer (and so its ``train``) and both training CLIs run
    on the card unless asked for the CPU."""
    from deeplip_tpu_torch.cli import train_fusion, train_video

    _no_card(monkeypatch)
    video_tcn = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3],
                 "tcn_num_layers": 1}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusionTrainer(ETDNN_MODEL_OPTS, video_tcn, 2, audio_data_opts=AUDIO_DATA_OPTS,
                      fusion_head="cbp")
    fusion = tmp_path / "fusion.json"
    fusion.write_text(json.dumps({
        "data": {"python_data_config": AUDIO_DATA_OPTS},
        "model": {"audio_config": ETDNN_MODEL_OPTS, "video_config": {"tcn": video_tcn}},
        "train": {"n_spk": 2}, "test": {}}))
    for mode in ("train", "test"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_fusion.main(["--config", str(fusion), "--mode", mode,
                               "--exp-root", str(tmp_path)])
    clips = tmp_path / "clips" / "s0"
    clips.mkdir(parents=True)
    np.savez(str(clips / "c0.npz"), data=np.zeros((4, 96, 96), np.uint8))
    video = tmp_path / "video.json"
    video.write_text(json.dumps(video_tcn))
    for extra in ([], ["--extract-feats"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_video.main(["--config-path", str(video), "--data-dir",
                              str(tmp_path / "clips")] + extra)
    # asked for the CPU, they run there
    trainer = FusionTrainer(ETDNN_MODEL_OPTS, video_tcn, 2, audio_data_opts=AUDIO_DATA_OPTS,
                            device="cpu")
    assert trainer.device == torch.device("cpu")


def test_variant_entry_points_raise_without_a_card(monkeypatch):
    """The audio ResNet, an attentive pooling, the ``stft`` front-end and the
    ShuffleNetV2 Lipreading with the depthwise-separable TCN go through the
    same entry points, on the card unless asked for the CPU."""
    _no_card(monkeypatch)
    resnet = Config({"model": {"arch": "resnet", "resnet": {
        "hidden_dim": [4, 8, 8], "residual_block_layers": [1, 1, 1], "embedding_dim": 8}},
        "data": {"python_data_config": AUDIO_DATA_OPTS}})
    attentive = Config({"model": {**ETDNN_MODEL_OPTS, "etdnn": {
        **ETDNN_MODEL_OPTS["etdnn"], "pooling": "mono_head_attention"}},
        "data": {"python_data_config": {"rate": 16000, "feat_type": "stft"}}})
    shufflenet = {"backbone_type": "shufflenet", "width_mult": 0.5, "relu_type": "prelu",
                  "tcn_kernel_size": [3], "tcn_num_layers": 1, "tcn_dwpw": True}
    for build in (lambda **kw: AudioExtractor(resnet, **kw),
                  lambda **kw: AudioTrainer(resnet, n_spk=4, **kw),
                  lambda **kw: SpeakerVerifier(attentive, **kw),
                  lambda **kw: VideoTrainer(shufflenet, 4, hidden_dim=8, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert build(device="cpu") is not None


class _Started(Exception):
    """Raised where a study starts its work, past its device check."""


@pytest.mark.parametrize("name,first", [
    ("convergence_study", "make_hard_audio_corpus"),
    ("convergence_video_study", "shared_data"),
    ("convergence_fusion_study", "shared_data"),
    ("resample_study", "make_audio_corpus")])
def test_research_drivers_raise_without_a_card(monkeypatch, tmp_path, name, first):
    """The four research drivers run on the card unless given ``--device
    cpu``: without it they raise before any work, with it they start."""
    import importlib

    module = importlib.import_module(f"deeplip_tpu_torch.cli.{name}")
    _no_card(monkeypatch)

    def started(*args, **kwargs):
        raise _Started

    monkeypatch.setattr(module, first, started)
    out = ["--out", str(tmp_path / "report")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(out)
    with pytest.raises(_Started):
        module.main(out + ["--device", "cpu"])
