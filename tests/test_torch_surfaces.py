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
  array, ``param_sharding``'s rule, ``pad_to_multiple``.
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
# JAX names whose meaning the port carries under another name
REPLACED = {("interop", "import_speaker_embnet_state_dict"): "clean_state_dict"}


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
