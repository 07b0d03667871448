"""Reference DeepLip ``.pth`` checkpoints into and out of the port, against
the JAX package's ``interop.torch_import`` / ``torch_export``.

The fixtures are written by the JAX package's ``save_reference_*_checkpoint``
from JAX weights: with and without the DataParallel ``module.`` prefix, with
the reference's extra ``fc3*`` keys, and a fusion checkpoint that pickles
its live criterion module, whose class cannot be imported when the file is
read. The port's loaders and the JAX package's read each file:

- the weights bit-equal, key by key (the JAX import taken back to the
  reference layout by its own exporter, or by ``interop.from_jax``);
- the audio embeddings of the two imports within 1e-4; the video frame
  features of the port's import equal to those of the JAX weights carried
  by ``interop.from_jax``;
- the fault: a ``module.``-prefixed audio file through ``SpeakerVerifier``,
  ``cli/verify.py`` and the fusion config's ``resume`` keys, which raised
  before the port had these loaders;
- the port's exporter (and ``cli/export_torch.py``) back into the JAX
  package's importer, bit-equal;
- each per-module converter against its JAX twin (E-TDNN with each pooling
  layout, LMCL, the criteria, LowFER, Lipreading, the ShuffleNetV2 trunk):
  the JAX export of seeded Flax parameters through the port's import gives
  the JAX module's outputs, and the port's export through the JAX import
  gives back the same parameters bit for bit; and
  ``load_reference_fusion_checkpoint(float_dtype)``.
"""

import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.interop import torch_export as JE
from deeplip_tpu.interop import torch_import as JI
from deeplip_tpu.models.lipreading import Lipreading as JaxLipreading
from deeplip_tpu_torch.cli import export_torch as cli_export
from deeplip_tpu_torch.cli import train_fusion as cli_fusion
from deeplip_tpu_torch.cli import verify as cli_verify
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.audio_io import write_wav
from deeplip_tpu_torch.interop import torch_export as PE
from deeplip_tpu_torch.interop import torch_import as PI
from deeplip_tpu_torch.interop.from_jax import lipreading_state_dict, speaker_embnet_state_dict
from deeplip_tpu_torch.models.fusion import LowFER
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.serve import SpeakerVerifier
from deeplip_tpu_torch.train.audio import AudioTrainer
from deeplip_tpu_torch.train.fusion import FusionTrainer
from tests.test_torch_extract_e2e import DATA
from tests.test_torch_tdnn import CONTEXTS, EMB, HIDDEN, _jax_net

torch.set_num_threads(1)

AUDIO_MODEL = {"arch": "tdnn", "tdnn": {
    "input_dim": 24, "hidden_dim": HIDDEN, "context": CONTEXTS, "tdnn_layers": len(CONTEXTS),
    "embedding_dim": EMB, "pooling": "statistic", "bn_first": True}}
VIDEO_CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3],
             "tcn_num_layers": 1, "tcn_dropout": 0.0, "tcn_dwpw": False}
VIDEO_KW = dict(hidden_dim=8, trunk_layers=(1, 1, 1, 1))
NC, N_SPK = 5, 4


def _audio_config():
    return {"data": DATA, "model": AUDIO_MODEL, "train": {"loss": "LMCL", "n_spk": N_SPK},
            "test": {"batch_size": 4, "n_buckets": 1}}


def _with_fc3(path):
    """The reference's stray third layer, added to a written checkpoint."""
    tree = torch.load(path, weights_only=True)
    prefix = "module." if next(iter(tree["state_dict"])).startswith("module.") else ""
    tree["state_dict"][prefix + "fc3.weight"] = torch.ones(3, 2)
    tree["state_dict"][prefix + "fc3.bias"] = torch.zeros(3)
    torch.save(tree, path)
    return path


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    """JAX E-TDNN weights and reference audio files written from them, with
    and without the DataParallel prefix, both with ``fc3*`` keys."""
    root = tmp_path_factory.mktemp("ckpt")
    model, params, stats = _jax_net(seed=2)
    files = {}
    for dp in (False, True):
        path = str(root / f"net_{int(dp)}.pth")
        JE.save_reference_audio_checkpoint(path, params, stats, epoch=3, pooling="statistic",
                                           data_parallel_prefix=dp)
        files[dp] = _with_fc3(path)
    return model, params, stats, files


def _jax_audio_sd(path):
    """The JAX package's import of ``path``, in the reference layout."""
    params, stats = JI.load_reference_audio_checkpoint(path, n_blocks=len(CONTEXTS))
    return JE.export_speaker_embnet_state_dict(params, stats, pooling="statistic")


def _assert_sd_equal(got, want, skip=("num_batches_tracked",)):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(skip):
            continue
        g = got[k].detach().cpu().numpy()
        assert g.dtype == np.asarray(v).dtype and g.shape == np.shape(v), k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("dp", [False, True], ids=["plain", "module_prefix"])
def test_audio_import_matches_jax(audio_files, dp):
    model, _, _, files = audio_files
    sd = PI.load_reference_audio_checkpoint(files[dp])
    _assert_sd_equal(sd, _jax_audio_sd(files[dp]))
    assert not any(k.startswith(("module.", "fc3")) for k in sd)
    assert all(int(v) == 0 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    # the embeddings of the two imports
    trainer = AudioTrainer(Config(_audio_config()), device="cpu", n_spk=N_SPK)
    trainer.load_torch_checkpoint(files[dp])
    params, stats = JI.load_reference_audio_checkpoint(files[dp], n_blocks=len(CONTEXTS))
    x = np.random.default_rng(1).standard_normal((3, 70, 24)).astype(np.float32)
    want, _ = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                          method=model.extract_embedding)
    with torch.no_grad():
        got, _ = trainer.model.eval().extract_embedding(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def _wav_corpus(root):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        n = int(rng.integers(9000, 14000))
        y = (0.3 * np.sin(2 * np.pi * (110 + 60 * i) * np.arange(n) / 16000.0)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        paths.append(os.path.join(root, f"u{i}.wav"))
        write_wav(paths[-1], y, 16000)
    return paths


def test_prefixed_audio_pth_serves_through_the_verifier_and_the_cli(audio_files, tmp_path,
                                                                    capsys):
    """The fault: a reference ``.pth`` with ``module.`` keys (and ``fc3*``)
    raised in ``SpeakerVerifier``; it now serves the same embeddings as the
    port's own checkpoint of the same weights."""
    _, params, stats, files = audio_files
    own = str(tmp_path / "net_3")
    torch.save({"epoch": 3, "state_dict": speaker_embnet_state_dict(params, stats)}, own)
    cfg_path = str(tmp_path / "audio.json")
    with open(cfg_path, "w") as fh:
        json.dump(_audio_config(), fh)
    wavs = _wav_corpus(str(tmp_path))
    ref = SpeakerVerifier(cfg_path, checkpoint=files[True], device="cpu")
    mine = SpeakerVerifier(cfg_path, checkpoint=own, device="cpu")
    _assert_sd_equal(ref.extractor.model.state_dict(), _jax_audio_sd(files[True]))
    got, want = ref.embed_files({p: p for p in wavs}), mine.embed_files({p: p for p in wavs})
    for p in wavs:
        assert torch.equal(got[p], want[p]), p
    for ckpt, tag in ((files[True], "ref"), (own, "own")):
        prof = str(tmp_path / f"profiles_{tag}")
        cli_verify.main(["enroll", "-c", cfg_path, "-p", prof, "--device", "cpu",
                         "--checkpoint", ckpt, "spk", *wavs[:2]])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_utts"] == 2
    np.testing.assert_array_equal(np.load(str(tmp_path / "profiles_ref" / "spk.npy")),
                                  np.load(str(tmp_path / "profiles_own" / "spk.npy")))


def _jax_video_weights(**widths):
    jm = JaxLipreading.from_config(JaxConfig(VIDEO_CFG), NC)
    jm = jm.clone(**(VIDEO_KW if widths == {} else widths))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 24, 24, 1), jnp.float32))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0, 0.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return params, stats


def _fusion_trainer(**kw):
    return FusionTrainer(AUDIO_MODEL, VIDEO_CFG, n_spk=N_SPK, audio_data_opts=DATA[
        "python_data_config"], device="cpu", video_hidden_dim=8,
        video_trunk_layers=(1, 1, 1, 1), **kw)


def test_video_import_merges_over_the_network_like_jax(tmp_path):
    params, stats = _jax_video_weights()
    path = str(tmp_path / "video.pth")
    JE.save_reference_video_checkpoint(path, params, stats, data_parallel_prefix=True)
    port = Lipreading.from_config(VIDEO_CFG, NC, **VIDEO_KW)
    sd = PI.load_reference_video_checkpoint(path, port.state_dict())
    jp, js = JI.load_reference_video_checkpoint(path, layers=(1, 1, 1, 1))
    _assert_sd_equal(sd, lipreading_state_dict(jp, js))
    # frame features: the port's import against the JAX weights carried by from_jax
    want = Lipreading.from_config(VIDEO_CFG, NC, **VIDEO_KW).eval()
    want.load_state_dict(lipreading_state_dict(params, stats))
    port.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 24, 24, 1)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(port.eval().frame_features(x), want.frame_features(x))
    # the fusion trainer takes it with its own classifier size (n_spk != NC)
    trainer = _fusion_trainer()
    trainer.load_torch_encoders(None, path)
    assert trainer.video_model.tcn.tcn_output.out_features == NC
    _assert_sd_equal(trainer.video_model.state_dict(), lipreading_state_dict(jp, js))
    # only the classifier may be missing; a missing trunk key raises
    tree = torch.load(path, weights_only=True)
    del tree["module.tcn.tcn_output.weight"], tree["module.tcn.tcn_output.bias"]
    torch.save(tree, path)
    merged = PI.load_reference_video_checkpoint(path, port.state_dict())
    assert torch.equal(merged["tcn.tcn_output.weight"], port.tcn.tcn_output.weight)
    del tree["module.trunk.layer1.0.conv1.weight"]
    torch.save(tree, path)
    with pytest.raises(KeyError, match="trunk.layer1.0.conv1.weight"):
        PI.load_reference_video_checkpoint(path, port.state_dict())


class _ReferenceCrossEntropy(nn.Module):
    """The reference's fusion criterion as its trainer pickles it."""

    def __init__(self, dim, n):
        super().__init__()
        self.fc = nn.Linear(dim, n)


def _fusion_file(path, with_criterion_object=True, data_parallel_prefix=False):
    """A reference fusion ``net_*.pth`` from JAX LowFER weights; with the
    criterion module pickled from a package that is gone when it is read."""
    rng = np.random.default_rng(6)
    head = {"U": rng.uniform(-1, 1, (EMB, 30 * EMB)).astype(np.float32),
            "V": rng.uniform(-1, 1, (512, 30 * EMB)).astype(np.float32)}
    JE.save_reference_fusion_checkpoint(path, head, epoch=2,
                                        data_parallel_prefix=data_parallel_prefix)
    if with_criterion_object:
        tree = torch.load(path, weights_only=True)
        mod = types.ModuleType("reference_loss")
        cls = type("CrossEntropy", (_ReferenceCrossEntropy,), {"__module__": "reference_loss"})
        mod.CrossEntropy = cls
        sys.modules["reference_loss"] = mod
        try:
            torch.manual_seed(0)
            tree["criterion"] = cls(3 * EMB, N_SPK)
            torch.save(tree, path)
        finally:
            del sys.modules["reference_loss"]
    return head


def test_fusion_import_recovers_a_pickled_criterion_like_jax(tmp_path):
    path = str(tmp_path / "net_2.pth")
    head = _fusion_file(path, data_parallel_prefix=True)
    with pytest.raises(ModuleNotFoundError):
        torch.load(path, weights_only=False)
    got_head, got_crit = PI.load_reference_fusion_checkpoint(path)
    want_head, want_crit = JI.load_reference_fusion_checkpoint(path)
    for k in ("U", "V"):
        np.testing.assert_array_equal(got_head[k].numpy(), want_head[k])
        np.testing.assert_array_equal(got_head[k].numpy(), head[k])
    _assert_sd_equal(got_crit, JE.export_criterion_state_dict(want_crit))
    # the head and criterion go into a LowFER fusion trainer; its gate
    # projection keeps its own weights
    trainer = _fusion_trainer()
    gate = trainer.fusion_head.gate_proj.weight.detach().clone()
    trainer.load_torch_fusion_head(path)
    assert torch.equal(trainer.fusion_head.U, got_head["U"])
    assert torch.equal(trainer.criterion.fc.weight, got_crit["fc.weight"])
    assert torch.equal(trainer.fusion_head.gate_proj.weight, gate)
    with pytest.raises(NotImplementedError, match="LowFER"):
        _fusion_trainer(fusion_head="linear").load_torch_fusion_head(path)


def test_the_tolerant_read_is_only_for_a_named_pth(tmp_path):
    """A file that is not a ``.pth`` is read with ``weights_only`` alone;
    the tolerant read stubs every class but torch's tensor machinery, so a
    pickled callable runs nothing."""
    path = str(tmp_path / "net_2.pth")
    _fusion_file(path)
    plain = str(tmp_path / "net_2")
    os.replace(path, plain)
    with pytest.raises(pickle.UnpicklingError):
        PI.read_checkpoint(plain)

    class Payload:
        def __reduce__(self):
            return (os.remove, (plain,))

    evil = str(tmp_path / "evil.pth")
    torch.save({"state_dict": {"U": torch.ones(1)}, "x": Payload()}, evil)
    tree = PI.read_checkpoint(evil)
    assert os.path.exists(plain) and isinstance(tree["x"], PI._Stub)


def test_pth_resume_keys_of_the_fusion_cli(audio_files, tmp_path):
    """The fault through the fusion config: a prefixed reference audio
    ``.pth`` and a reference video ``.pth`` in the encoders' ``resume`` keys,
    and a reference fusion ``.pth`` in ``train.resume``."""
    _, _, _, files = audio_files
    # the fusion config builds the Lipreading encoder at its full width
    params, stats = _jax_video_weights(hidden_dim=256, trunk_layers=(2, 2, 2, 2))
    video = str(tmp_path / "video.pth")
    JE.save_reference_video_checkpoint(video, params, stats)
    fusion = str(tmp_path / "net_2.pth")
    head = _fusion_file(fusion)
    cfg = Config({
        "data": {"python_data_config": DATA["python_data_config"]},
        "model": {"audio_config": AUDIO_MODEL, "video_config": {"tcn": VIDEO_CFG}},
        "train": {"n_spk": N_SPK, "resume": fusion, "audio_config": {"resume": files[True]},
                  "video_config": {"resume": video}},
        "test": {}})
    trainer = cli_fusion.make_trainer(cfg, str(tmp_path / "exp"), "run", mode="av_test",
                                      device="cpu")
    _assert_sd_equal(trainer.audio_model.state_dict(), _jax_audio_sd(files[True]))
    jp, js = JI.load_reference_video_checkpoint(video)
    want = lipreading_state_dict(jp, js)
    got = trainer.video_model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    np.testing.assert_array_equal(trainer.fusion_head.V.detach().numpy(), head["V"])


def _port_audio_state(seed=3):
    _, params, stats = _jax_net(seed=seed)
    return speaker_embnet_state_dict(params, stats)


@pytest.mark.parametrize("dp", [False, True], ids=["plain", "module_prefix"])
def test_export_round_trips_into_jax(tmp_path, dp):
    sd = _port_audio_state()
    crit = {"weights": torch.randn(N_SPK, EMB)}
    path = str(tmp_path / "a.pth")
    PE.save_reference_audio_checkpoint(path, sd, epoch=4, criterion_state_dict=crit,
                                       data_parallel_prefix=dp)
    tree = torch.load(path, weights_only=True)
    assert set(tree) == {"epoch", "state_dict", "optimizer", "criterion_state_dict"}
    assert tree["epoch"] == 4 and tree["optimizer"] == {}
    assert all(k.startswith("module.") == dp for k in tree["state_dict"])
    _assert_sd_equal(sd, _jax_audio_sd(path))

    vp, vs = _jax_video_weights()
    vpath = str(tmp_path / "v.pth")
    PE.save_reference_video_checkpoint(vpath, lipreading_state_dict(vp, vs),
                                       data_parallel_prefix=dp)
    jvp, jvs = JI.load_reference_video_checkpoint(vpath, layers=(1, 1, 1, 1))
    _assert_sd_equal(lipreading_state_dict(jvp, jvs), lipreading_state_dict(vp, vs))

    head = LowFER(input_dims=(EMB, 512), output_dim=EMB)
    ce = {"fc.weight": torch.randn(N_SPK, 3 * EMB), "fc.bias": torch.randn(N_SPK)}
    fpath = str(tmp_path / "f.pth")
    PE.save_reference_fusion_checkpoint(fpath, head.state_dict(), epoch=1,
                                        criterion_state_dict=ce, data_parallel_prefix=dp)
    jh, jc = JI.load_reference_fusion_checkpoint(fpath)
    np.testing.assert_array_equal(jh["U"], head.U.detach().numpy())
    np.testing.assert_array_equal(jh["V"], head.V.detach().numpy())
    np.testing.assert_array_equal(jc["fc"]["kernel"], ce["fc.weight"].numpy().T)
    with pytest.raises(ValueError, match="LowFER"):
        PE.save_reference_fusion_checkpoint(fpath, {"fc1.weight": torch.ones(1)})


def test_export_cli_writes_what_the_jax_import_reads(tmp_path, capsys):
    sd = _port_audio_state(seed=4)
    ckpt = str(tmp_path / "net_avg")
    torch.save({"epoch": 7, "state_dict": sd, "criterion": {"weights": torch.ones(N_SPK, EMB)},
                "optimizer": {}}, ckpt)
    out = cli_export.main(["audio", "--checkpoint", ckpt, "--out", str(tmp_path / "o.pth"),
                           "--dp-prefix"])
    assert "wrote" in capsys.readouterr().out
    _assert_sd_equal(sd, _jax_audio_sd(out))
    tree = torch.load(out, weights_only=True)
    assert tree["epoch"] == 7 and torch.equal(tree["criterion_state_dict"]["weights"],
                                              torch.ones(N_SPK, EMB))
    # and back into the port, through the same suffix dispatch
    assert PI.load_reference_audio_checkpoint(out).keys() == sd.keys()
    # a pooling layout is read only where the model has an attentive pooling
    # (tests/test_torch_pooling.py exports those); this one has none
    again = cli_export.main(["audio", "--checkpoint", ckpt, "--out", str(tmp_path / "p.pth"),
                             "--pooling", "attentive_statistic"])
    _assert_sd_equal(sd, _jax_audio_sd(again))


# -- the per-module converters against their JAX twins ------------------------

def _tree_equal(got, want, what=""):
    if isinstance(want, dict):
        # Flax keeps an empty collection for a module without statistics
        got, want = ({k: v for k, v in t.items() if not (isinstance(v, dict) and not v)}
                     for t in (got, want))
        assert set(got) == set(want), what
        for k in want:
            _tree_equal(got[k], want[k], f"{what}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("pooling,layout", [("statistic", "attentive_statistic"),
                                            ("attentive_statistic", "attentive_statistic"),
                                            ("mono_head_attention", "mono_head_attention")])
def test_speaker_embnet_converters_round_trip_with_jax(pooling, layout):
    from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet

    model, params, stats = _jax_net(pooling=pooling, seed=5)
    ref = JE.export_speaker_embnet_state_dict(params, stats, pooling=layout)
    ref["fc3.weight"] = np.ones((3, 2), np.float32)   # the reference's stray layer
    sd = PI.import_speaker_embnet_state_dict(ref, n_blocks=len(CONTEXTS))
    net = SpeakerEmbNet(CONTEXTS, HIDDEN, input_dim=24, embedding_dim=EMB,
                        pooling=pooling).eval()
    net.load_state_dict(sd, strict=True)
    x = np.random.default_rng(2).standard_normal((3, 70, 24)).astype(np.float32)
    want, _ = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                          method=model.extract_embedding)
    with torch.no_grad():
        got, _ = net.extract_embedding(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    back_p, back_s = JI.import_speaker_embnet_state_dict(
        PE.export_speaker_embnet_state_dict(net.state_dict(), pooling=layout),
        n_blocks=len(CONTEXTS))
    _tree_equal(back_p, params)
    _tree_equal(back_s, stats)
    # the first n blocks only, as the JAX converter reads them
    assert not any(k.startswith("tdnn.2.") for k in PI.import_speaker_embnet_state_dict(
        ref, n_blocks=2))


def test_criterion_converters_round_trip_with_jax():
    from deeplip_tpu.losses.softmax import CrossEntropyHead as JaxCE, LMCL as JaxLMCL
    from deeplip_tpu_torch.losses.softmax import CrossEntropyHead, LMCL

    rng = np.random.default_rng(3)
    emb = rng.standard_normal((4, 16)).astype(np.float32)
    labels = rng.integers(0, 6, 4)
    for jax_head, port_head in ((JaxLMCL(num_classes=6), LMCL(6, 16)),
                                (JaxCE(num_classes=6), CrossEntropyHead(6, 16))):
        v = jax_head.init(jax.random.PRNGKey(1), jnp.asarray(emb), jnp.asarray(labels))
        params = jax.tree_util.tree_map(np.asarray, v["params"])
        ref = JE.export_criterion_state_dict(params)
        port_head.load_state_dict(PI.import_criterion_state_dict(ref), strict=True)
        jl, jlogits = jax_head.apply({"params": params}, jnp.asarray(emb), jnp.asarray(labels))
        pl, plogits = port_head(torch.from_numpy(emb), torch.from_numpy(labels))
        np.testing.assert_allclose(plogits.detach().numpy(), np.asarray(jlogits), atol=1e-5)
        np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
        _tree_equal(JI.import_criterion_state_dict(
            PE.export_criterion_state_dict(port_head.state_dict())), params)
        if "weights" in params:   # LMCL's own pair
            assert set(PI.import_lmcl_state_dict(JE.export_lmcl_state_dict(params))) == {
                "weights"}
            _tree_equal(JI.import_lmcl_state_dict(PE.export_lmcl_state_dict(
                port_head.state_dict())), params)
    assert PI.import_criterion_state_dict({"other": torch.zeros(2)}) is None
    assert PE.export_criterion_state_dict({"other": torch.zeros(2)}) is None


def test_lowfer_converters_round_trip_with_jax():
    rng = np.random.default_rng(4)
    head = {"U": rng.uniform(-1, 1, (EMB, 30 * EMB)).astype(np.float32),
            "V": rng.uniform(-1, 1, (24, 30 * EMB)).astype(np.float32)}
    sd = PI.import_lowfer_state_dict({"module." + k: v for k, v in
                                      JE.export_lowfer_state_dict(head).items()})
    port = LowFER(input_dims=(EMB, 24), output_dim=EMB)
    port.load_state_dict({**port.state_dict(), **sd}, strict=True)
    _tree_equal(JI.import_lowfer_state_dict(PE.export_lowfer_state_dict(port.state_dict())),
                head)


def test_lipreading_converters_round_trip_with_jax():
    params, stats = _jax_video_weights()
    ref = JE.export_lipreading_state_dict(params, stats)
    port = Lipreading.from_config(VIDEO_CFG, NC, **VIDEO_KW).eval()
    port.load_state_dict({**port.state_dict(),
                          **PI.import_lipreading_state_dict(ref, layers=(1, 1, 1, 1))},
                         strict=True)
    want = Lipreading.from_config(VIDEO_CFG, NC, **VIDEO_KW).eval()
    want.load_state_dict(lipreading_state_dict(params, stats))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 24, 24, 1)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(port.frame_features(x), want.frame_features(x))
    back_p, back_s = JI.import_lipreading_state_dict(
        PE.export_lipreading_state_dict(port.state_dict()), layers=(1, 1, 1, 1))
    _tree_equal(back_p, params)
    _tree_equal(back_s, stats)


def test_shufflenet_trunk_converters_round_trip_with_jax():
    from deeplip_tpu.models.shufflenetv2 import ShuffleNetV2Trunk as JaxTrunk
    from deeplip_tpu_torch.models.shufflenetv2 import ShuffleNetV2Trunk

    jtrunk = JaxTrunk(width_mult=0.5)
    x = np.random.default_rng(6).standard_normal((2, 16, 16, 24)).astype(np.float32)
    v = jtrunk.init(jax.random.PRNGKey(2), jnp.asarray(x))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0, 0.5, a.shape).astype(np.float32),
        v["batch_stats"])
    want = np.asarray(jtrunk.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    port = ShuffleNetV2Trunk(0.5).eval()
    port.load_state_dict(PI.import_shufflenet_trunk_state_dict(
        JE.export_shufflenet_trunk_state_dict(params, stats)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    back_p, back_s = JI.import_shufflenet_trunk_state_dict(
        PE.export_shufflenet_trunk_state_dict(port.state_dict()))
    _tree_equal(back_p, params)
    _tree_equal(back_s, stats)


@pytest.mark.parametrize("float_dtype", [np.float32, np.float64])
def test_fusion_loader_takes_a_float_dtype_like_jax(tmp_path, float_dtype):
    path = str(tmp_path / "net_2.pth")
    _fusion_file(path)
    got_head, got_crit = PI.load_reference_fusion_checkpoint(path, float_dtype=float_dtype)
    want_head, want_crit = JI.load_reference_fusion_checkpoint(path, float_dtype=float_dtype)
    _tree_equal({k: v.numpy() for k, v in got_head.items()}, want_head)
    assert got_crit["fc.weight"].numpy().dtype == float_dtype
    np.testing.assert_array_equal(got_crit["fc.weight"].numpy(),
                                  want_crit["fc"]["kernel"].T)
    np.testing.assert_array_equal(got_crit["fc.bias"].numpy(), want_crit["fc"]["bias"])
    torch_head, _ = PI.load_reference_fusion_checkpoint(path, float_dtype=torch.float64)
    assert torch_head["U"].dtype == torch.float64
