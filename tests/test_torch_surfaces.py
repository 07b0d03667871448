"""The port's package surfaces and its last public helpers, against the JAX
package.

- every name of the JAX ``__all__`` lists of ``core``, ``data``, ``eval``,
  ``interop``, ``losses``, ``models`` and ``ops`` imports from the port's
  package of the same name, or its listed replacement does;
- the masked reductions, ``pad_for_frames``, ``rgb_to_gray`` (as
  ``tests/test_video_pipeline.py`` holds the JAX one to cv2's weights),
  ``add_noise_snr``, ``normalize_utterance`` and ``load_video_config`` agree
  with their JAX twins on the same inputs (f32, within 1e-6 unless noted);
- the process mesh without a process group: ``make_mesh``'s ``-1`` rule and
  the row rule of ``data_sharding`` against the JAX sharding of the same
  array, ``param_sharding``'s rule, ``pad_to_multiple``;
- the last surfaces: ``resample(method='polyphase')`` bit-equal to JAX,
  ``FusionTrainer(scale, margin)``'s LMCL against the JAX trainer's
  criterion, ``ResNetTrunk(avg_pool_downsample=True)`` against the JAX
  trunk, ``utterances_from_trials_list``;
- name by name: every public function and class of each JAX module, and
  every argument and public method of them, has its counterpart in the
  port's module of the same path, or stands in an allowlist below with the
  reason the port does without it.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplip_tpu.core.config as JC
import deeplip_tpu.core.mesh as JM
import deeplip_tpu.ops.framing as JF
import deeplip_tpu.ops.masked as JMask
import deeplip_tpu.ops.video as JV
from deeplip_tpu_torch.core import config as PC
from deeplip_tpu_torch.core import mesh as PM
from deeplip_tpu_torch.ops import framing as PF
from deeplip_tpu_torch.ops import masked as PMask
from deeplip_tpu_torch.ops import video as PV

torch.set_num_threads(1)

PACKAGES = ("core", "data", "eval", "interop", "losses", "models", "ops")
# JAX names whose meaning the port carries under another name (none left)
REPLACED = {}


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_the_jax_names(package):
    jax_pkg = importlib.import_module(f"deeplip_tpu.{package}")
    port = importlib.import_module(f"deeplip_tpu_torch.{package}")
    for name in jax_pkg.__all__:
        name = REPLACED.get((package, name), name)
        assert name in port.__all__, name
        assert getattr(port, name) is not None
        exec(f"from deeplip_tpu_torch.{package} import {name}", {})
    # the JAX names less the replaced ones are exported, plus the mesh helpers
    missing = {n for n in jax_pkg.__all__ if (package, n) not in REPLACED} - set(port.__all__)
    assert not missing


def test_core_exports_the_mesh_under_the_jax_names():
    import deeplip_tpu_torch.core as core

    for name in ("make_mesh", "data_sharding", "replicated_sharding", "param_sharding",
                 "replicate", "pad_to_multiple", "stacked_data_sharding", "DATA_AXIS",
                 "MODEL_AXIS", "DCN_AXIS", "initialize", "make_multihost_mesh", "dp_spec"):
        assert name in core.__all__, name
    assert (core.DATA_AXIS, core.MODEL_AXIS, core.DCN_AXIS) == (JM.DATA_AXIS, JM.MODEL_AXIS,
                                                                JM.DCN_AXIS)


def _masked_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    lengths = np.array([7, 3, 0])
    mask = (np.arange(7)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x, mask


@pytest.mark.parametrize("axis", [1, -2])
def test_masked_reductions_match_jax(axis):
    x, mask = _masked_inputs()
    tx, tm = torch.tensor(x), torch.tensor(mask)
    np.testing.assert_allclose(PMask.masked_mean(tx, tm, axis).numpy(),
                               np.asarray(JMask.masked_mean(x, mask, axis)), atol=1e-6)
    for ddof, eps in ((1, 0.0), (0, 1e-5)):
        np.testing.assert_allclose(PMask.masked_std(tx, tm, axis, ddof, eps).numpy(),
                                   np.asarray(JMask.masked_std(x, mask, axis, ddof, eps)),
                                   atol=1e-6)
    mean, std = PMask.masked_mean_std(tx, tm, axis)
    jmean, jstd = JMask.masked_mean_std(x, mask, axis)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), atol=1e-6)


def test_fusion_masked_mean_is_the_masked_mean():
    from deeplip_tpu_torch.ops.masked import length_mask
    from deeplip_tpu_torch.train.fusion import _masked_mean

    x, _ = _masked_inputs(1)
    lengths = torch.tensor([7, 3, 0])
    want = (torch.tensor(x) * length_mask(lengths, 7)[..., None]).sum(1) / torch.clamp(
        length_mask(lengths, 7).sum(1, keepdim=True), min=1.0)
    assert torch.equal(_masked_mean(torch.tensor(x), lengths), want)


@pytest.mark.parametrize("n", [400, 401, 560, 1000, 1])
def test_pad_for_frames_matches_jax(n):
    sig = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    got = PF.pad_for_frames(torch.tensor(sig), 400, 160).numpy()
    want = np.asarray(JF.pad_for_frames(jnp.asarray(sig), 400, 160))
    np.testing.assert_array_equal(got, want)


def test_rgb_to_gray_matches_cv2_weights():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (2, 4, 4, 3)).astype(np.float32)
    got = PV.rgb_to_gray(torch.tensor(img)).numpy()
    want = img @ np.array([0.299, 0.587, 0.114], np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(JV.rgb_to_gray(jnp.asarray(img))), atol=1e-4)


def test_add_noise_snr_and_normalize_utterance_match_jax():
    rng = np.random.default_rng(2)
    sig = rng.standard_normal((3, 800)).astype(np.float32)
    noise = rng.standard_normal((3, 800)).astype(np.float32)
    for snr in (0.0, 10.0, -5.0):
        np.testing.assert_allclose(
            PV.add_noise_snr(torch.tensor(sig), torch.tensor(noise), snr).numpy(),
            np.asarray(JV.add_noise_snr(sig, noise, snr)), rtol=1e-5, atol=1e-5)
    sig[1] = 0.25   # a constant row keeps std 1
    np.testing.assert_allclose(PV.normalize_utterance(torch.tensor(sig)).numpy(),
                               np.asarray(JV.normalize_utterance(sig)), atol=1e-5)


def test_load_video_config_matches_jax(tmp_path):
    path = tmp_path / "video.json"
    path.write_text(json.dumps({"backbone_type": "resnet", "tcn_kernel_size": [3, 5, 7],
                                "tcn_dropout": 0.2}))
    assert dict(PC.load_video_config(str(path))) == dict(JC.load_video_config(str(path)))


def test_mesh_without_a_process_group():
    mesh = PM.make_mesh()
    assert (mesh.axis_names, mesh.shape, mesh.rank) == (("data",), (1,), 0)
    assert mesh.data_group is None and mesh.world_group is None and mesh.is_main
    assert PM.make_mesh([("data", -1), ("model", 1)]).shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        PM.make_mesh([("data", 2)])
    x = torch.arange(6.0)
    assert torch.equal(PM.data_sharding(mesh, 1)(x), x)
    mesh.reduce_gradients([torch.nn.Parameter(torch.ones(2))])   # no group: a no-op
    assert mesh.report(loss=torch.tensor(1.5))["loss"] == 1.5


@pytest.mark.parametrize("layout", [[("data", 4)], [("data", 2), ("model", 2)],
                                    [("dcn", 2), ("data", 2)]])
def test_row_rule_matches_the_jax_data_sharding(layout):
    """Each rank's rows are the rows the JAX ``data_sharding`` puts on the
    device at the same mesh coordinates (rank ``r`` = device ``r``)."""
    shape = tuple(n for _, n in layout)
    jmesh = JM.make_mesh(layout, devices=jax.devices()[:int(np.prod(shape))])
    batch = np.arange(8 * 3).reshape(8, 3)
    arr = jax.device_put(batch, JM.data_sharding(jmesh, 2))
    on_device = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    for rank, device in enumerate(jmesh.devices.reshape(-1)):
        mesh = PM.Mesh(tuple(n for n, _ in layout), shape, rank)
        np.testing.assert_array_equal(PM.data_sharding(mesh, 2)(batch), on_device[device.id])
        stacked = np.stack([batch, batch + 100])
        np.testing.assert_array_equal(PM.stacked_data_sharding(mesh, 3)(stacked),
                                      stacked[:, mesh.rows(8)])


def test_param_sharding_rule():
    mesh = PM.Mesh(("data", "model"), (2, 2), rank=3)
    tree = {"criterion.weights": torch.zeros(8, 4), "criterion.fc.bias": torch.zeros(8),
            "model.fc1.weight": torch.zeros(8, 4), "criterion.odd": torch.zeros(7, 4)}
    got = PM.param_sharding(mesh, tree)
    assert got["criterion.weights"] == PM.RowSharding(1, 2)
    assert got["criterion.weights"].rows(8) == slice(4, 8)
    assert got["criterion.fc.bias"] == PM.RowSharding(1, 2)
    assert got["model.fc1.weight"] is None and got["criterion.odd"] is None
    assert all(v is None for v in PM.param_sharding(PM.Mesh(("data",), (4,), 1), tree).values())


@pytest.mark.parametrize("n,m", [(0, 4), (5, 4), (8, 4), (9, 1), (13, 8)])
def test_pad_to_multiple_matches_jax(n, m):
    assert PM.pad_to_multiple(n, m) == JM.pad_to_multiple(n, m)


@pytest.mark.parametrize("rates", [(44100, 16000), (16000, 8000), (8000, 16000), (22050, 16000)])
def test_resample_methods_match_jax(rates):
    from deeplip_tpu.data import audio_io as JA
    from deeplip_tpu_torch.data import audio_io as PA

    y = np.random.default_rng(rates[0]).standard_normal(2205).astype(np.float32)
    for method in ("polyphase", "kaiser_best"):
        got = PA.resample(y, *rates, method=method)
        want = JA.resample(y, *rates, method=method)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PA.resample(y, *rates), JA.resample(y, *rates))
    with pytest.raises(ValueError, match="unknown resample method"):
        PA.resample(y, *rates, method="sinc_fastest")


def test_fusion_trainer_takes_the_criterions_scale_and_margin():
    from deeplip_tpu.core.config import Config as JaxConfig
    from deeplip_tpu.train.fusion import FusionTrainer as JaxFusionTrainer
    from deeplip_tpu_torch.train.fusion import FusionTrainer

    audio = {"arch": "tdnn", "tdnn": {
        "input_dim": 24, "hidden_dim": [16, 16, 32], "context": [[-2, -1, 0, 1, 2], [-2, 0, 2],
                                                                 [0]],
        "tdnn_layers": 3, "embedding_dim": 16, "pooling": "statistic", "bn_first": True}}
    video = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3],
             "tcn_num_layers": 1, "tcn_dropout": 0.0, "tcn_dwpw": False, "tcn_width_mult": 1,
             "width_mult": 1.0}
    kw = dict(loss="LMCL", scale=20.0, margin=0.35, video_hidden_dim=8,
              video_trunk_layers=(1, 1, 1, 1), crop_size=(16, 16))
    port = FusionTrainer(audio, video, 5, device="cpu", **kw)
    jtr = JaxFusionTrainer(JaxConfig(audio), JaxConfig(video), n_spk=5,
                           mesh=JM.make_mesh(devices=jax.devices()[:1]), **kw)
    assert (port.criterion.scale, port.criterion.init_margin) == (20.0, 0.35)
    assert (jtr.criterion.scale, jtr.criterion.init_margin) == (20.0, 0.35)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((6, port.criterion.weights.shape[1])).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    w = port.criterion.weights.detach().numpy()
    jloss, jlogits = jtr.criterion.apply({"params": {"weights": w}}, jnp.asarray(emb),
                                         jnp.asarray(labels), reduction="none")
    loss, logits = port.criterion(torch.tensor(emb), torch.tensor(labels), reduction="none")
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-6)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss), rtol=1e-5, atol=1e-5)
    scaled, _ = port.criterion.class_logits(torch.tensor(emb),
                                            torch.nn.functional.one_hot(torch.tensor(labels), 5))
    want = 20.0 * (np.asarray(jlogits) - 0.35 * np.eye(5)[labels])
    np.testing.assert_allclose(scaled.detach().numpy(), want, atol=2e-5)


def _export_resnet_trunk(params, stats):
    from deeplip_tpu.interop.torch_export import export_lipreading_state_dict

    tree_p = {"frontend_conv": {"kernel": np.zeros((1, 1, 1, 1, 64), np.float32)},
              "frontend_bn": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)},
              "trunk": params}
    tree_s = {"frontend_bn": {"mean": np.zeros(64, np.float32), "var": np.ones(64, np.float32)},
              "trunk": stats}
    sd = export_lipreading_state_dict(tree_p, tree_s)
    return {k[len("trunk."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()
            if k.startswith("trunk.")}


@pytest.mark.parametrize("avg_pool_downsample", [True, False])
def test_resnet_trunk_avg_pool_downsample_matches_jax(avg_pool_downsample):
    from deeplip_tpu.models.resnet import ResNetTrunk as JaxTrunk
    from deeplip_tpu_torch.models.resnet import ResNetTrunk

    layers = (1, 1, 1, 1)
    x = np.random.default_rng(1).standard_normal((2, 11, 11, 64)).astype(np.float32)
    jtrunk = JaxTrunk(layers=layers, avg_pool_downsample=avg_pool_downsample)
    variables = jtrunk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jtrunk.apply(variables, jnp.asarray(x)))
    trunk = ResNetTrunk(layers, avg_pool_downsample=avg_pool_downsample).eval()
    assert all(b.avg_pool_downsample == avg_pool_downsample
               for stage in (trunk.layer2, trunk.layer3, trunk.layer4) for b in stage)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    trunk.load_state_dict(_export_resnet_trunk(params, stats), strict=True)
    with torch.no_grad():
        got = trunk(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_utterances_from_trials_list_matches_jax(tmp_path):
    from deeplip_tpu.cli.train_audio import utterances_from_trials_list as jax_utts
    from deeplip_tpu_torch.cli.train_audio import utterances_from_trials_list

    names = ["s01/u0.wav", "s02/u3.wav"]
    got = utterances_from_trials_list(names, str(tmp_path))
    want = jax_utts(names, str(tmp_path))
    assert [(u.name, u.path) for u in got] == [(u.name, u.path) for u in want]


# -- name by name ------------------------------------------------------------
# Flax module fields and hooks: the port's torch modules have none of them
FLAX_NAMES = {"parent", "name", "dtype", "setup"}
# whole JAX modules with no module of that path in the port
NOT_PORTED_MODULES = {
    "deeplip_tpu.ops.pallas": "the Pallas kernels; the port's hand-written CUDA kernels are "
                              "ops/cuda (csrc/*.cu)",
    "deeplip_tpu.ops.pallas.fbank_kernel": "Pallas K1/K2; the port's is ops/cuda/fbank.py",
    "deeplip_tpu.ops.pallas.bn_prelu_kernel": "Pallas K3/K4; the port's is ops/cuda/bn_prelu.py",
    "deeplip_tpu.ops.precision": "emulates the TPU's bf16 matmul passes; precision names map to "
                                 "FP32/TF32 choices in the port",
    "deeplip_tpu.native.libdeeplip_native": "the compiled C++ library, not a Python module; the "
                                           "port builds its own (deeplip_tpu_torch/native)",
}
# public functions and classes the port does without
NOT_PORTED_NAMES = {
    ("deeplip_tpu.core.mesh", "force_host_devices"): "XLA host-platform devices; the port's "
                                                     "mesh is processes",
    ("deeplip_tpu.data.prefetch", "device_prefetch"): "the port stages batches on a side stream "
                                                      "(train/audio.py: _device_batches)",
    ("deeplip_tpu.models.lipreading", "FrontendConv3D"): "the space-to-depth MXU form of the "
                                                        "frontend conv; the port runs the direct "
                                                        "Conv3d",
    ("deeplip_tpu.ops.video", "frontend_conv3d_s2d"): "an MXU layout trick; the port runs the "
                                                      "direct Conv3d",
    ("deeplip_tpu.train.checkpoint", "fetch_tree"): "Orbax; the port's container is the .pth",
    ("deeplip_tpu.train.checkpoint", "wait_for_saves"): "Orbax asynchronous saves",
    ("deeplip_tpu.train.flops", "compiled_flops"): "reads XLA's cost analysis; FlopCounterMode "
                                                   "replaces it",
    ("deeplip_tpu.train.flops", "executable_flops"): "reads XLA's cost analysis",
    ("deeplip_tpu.train.state", "TrainState"): "a Flax and optax state; the port's trainers hold "
                                               "torch modules and optimizers",
}
# (module, name): the JAX arguments and methods the port does without
NOT_PORTED_ARGS = {
    ("deeplip_tpu.core.mesh", "make_mesh"): ({"devices"}, "JAX devices; the port's mesh is the "
                                                          "process group's ranks"),
    ("deeplip_tpu.data.sampler", "SpeakerBatchSampler"): ({"drop_last"}, "a knob no caller "
                                                          "sets; the port always drops the "
                                                          "partial batch, the JAX default"),
    ("deeplip_tpu.models.lipreading", "Lipreading"): ({"extract_feats"}, "the port's "
                                                      "frame_features method extracts"),
    ("deeplip_tpu.models.norm", "TorchBatchNorm"): ({"use_running_average", "epsilon"},
                                                    "Flax fields: torch's train()/eval() and "
                                                    "eps"),
    ("deeplip_tpu.models.resnet", "PReLU"): ({"init_alpha"}, "torch nn.PReLU's name, init"),
    ("deeplip_tpu.models.shufflenetv2", "InvertedResidual"): ({"features"}, "Flax's output "
                                                              "width field; torch takes inp, oup"),
    ("deeplip_tpu.models.tcn", "ConvBatchRelu"): ({"dwpw"}, "the port's dwpw unit is a module of "
                                                            "its own (DepthwiseSeparableConv)"),
    ("deeplip_tpu.models.tdnn", "TDNNBlock"): ({"features", "precision"}, "Flax's output width "
                                               "field; precision is ops/precision (not ported)"),
    ("deeplip_tpu.models.tdnn", "SpeakerEmbNet"): ({"conv_precision", "fc_precision"},
                                                   "ops/precision (not ported): FP32 in the port"),
    ("deeplip_tpu.ops.features", "FeatureConfig"): ({"precision"}, "ops/precision (not ported)"),
    ("deeplip_tpu.ops.features", "extract_features"): ({"backend"}, "XLA against Pallas; the "
                                                       "port picks by the tensor's device"),
    ("deeplip_tpu.ops.video", "random_crop"): ({"key"}, "the port draws with explicit "
                                                        "torch generators"),
    ("deeplip_tpu.ops.video", "horizontal_flip"): ({"key"}, "explicit torch generators"),
    ("deeplip_tpu.ops.video", "train_transform"): ({"key"}, "explicit torch generators"),
    ("deeplip_tpu.serve.verifier", "SpeakerVerifier"): ({"exp_root"}, "the port's verifier "
                                                        "holds an AudioExtractor, which writes "
                                                        "nothing"),
    ("deeplip_tpu.train.checkpoint", "save_checkpoint"): ({"asynchronous"}, "Orbax"),
    ("deeplip_tpu.train.checkpoint", "load_checkpoint"): ({"abstract_tree"}, "Orbax"),
    ("deeplip_tpu.train.video", "VideoTrainer"): ({"extract_feats", "ensure_state"},
                                                  "extract_feats is never read by the JAX "
                                                  "trainer; ensure_state builds its TrainState, "
                                                  "the port's state is built with the trainer"),
    ("deeplip_tpu.train.fusion", "FusionTrainer"): ({"ensure_state"}, "the port's state is "
                                                    "built with the trainer"),
    ("deeplip_tpu.interop.torch_import", "load_reference_audio_checkpoint"): (
        {"n_blocks"}, "the port returns the file's own state dict, not a Flax tree of that "
                      "depth"),
    ("deeplip_tpu.interop.torch_import", "load_reference_video_checkpoint"): (
        {"layers"}, "the port merges the file over the receiving network's state dict"),
    **{("deeplip_tpu.interop.torch_export", n): (
        {"params", "batch_stats", "stats", "criterion_params", "head_params"},
        "the port's modules hold the reference layout in one state dict, not Flax "
        "(params, batch_stats) trees")
       for n in ("export_speaker_embnet_state_dict", "export_lmcl_state_dict",
                 "export_criterion_state_dict", "export_lowfer_state_dict",
                 "export_shufflenet_trunk_state_dict", "export_lipreading_state_dict",
                 "save_reference_audio_checkpoint", "save_reference_video_checkpoint",
                 "save_reference_fusion_checkpoint")},
}


def _jax_modules():
    import pkgutil

    import deeplip_tpu

    return sorted(m.name for m in pkgutil.walk_packages(deeplip_tpu.__path__, "deeplip_tpu."))


def _public(module):
    import inspect

    return {n: v for n, v in vars(module).items()
            if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__}


def _arguments(obj) -> set:
    import inspect

    target = obj.__init__ if inspect.isclass(obj) else obj
    try:
        params = inspect.signature(target).parameters
    except (TypeError, ValueError):
        return set()
    return {p for p, v in params.items() if p != "self" and v.kind not in (
        v.VAR_POSITIONAL, v.VAR_KEYWORD)}


def _methods(cls) -> set:
    return {a for a, f in vars(cls).items() if not a.startswith("_") and callable(f)}


def test_every_jax_module_name_and_argument_has_a_counterpart():
    import inspect

    gaps, stale = [], set(NOT_PORTED_NAMES) | set(NOT_PORTED_ARGS)
    for name in _jax_modules():
        if name in NOT_PORTED_MODULES:
            continue
        jax_mod = importlib.import_module(name)
        port_mod = importlib.import_module("deeplip_tpu_torch" + name[len("deeplip_tpu"):])
        for obj_name, obj in _public(jax_mod).items():
            if not hasattr(port_mod, obj_name):
                if (name, obj_name) in NOT_PORTED_NAMES:
                    stale.discard((name, obj_name))
                else:
                    gaps.append(f"{name}.{obj_name}")
                continue
            port_obj = getattr(port_mod, obj_name)
            missing = (_arguments(obj) - _arguments(port_obj)) - FLAX_NAMES
            if inspect.isclass(obj):
                missing |= {m for m in _methods(obj) - FLAX_NAMES if not hasattr(port_obj, m)}
            allowed = NOT_PORTED_ARGS.get((name, obj_name), (set(), ""))[0]
            if missing:
                stale.discard((name, obj_name))
            if missing - allowed:
                gaps.append(f"{name}.{obj_name}: {sorted(missing - allowed)}")
    assert not gaps, gaps
    # an allowlist entry that no longer names a gap must go
    assert not stale, sorted(stale)
    assert all(reason for _, reason in NOT_PORTED_ARGS.values())
    assert all(NOT_PORTED_NAMES.values()) and all(NOT_PORTED_MODULES.values())
