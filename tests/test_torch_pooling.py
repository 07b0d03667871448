"""The port's attentive poolings against the JAX package's, alone and inside
the E-TDNN, and their reference ``.pth`` layouts both ways.

Each pooling gets the same seeded numpy parameters and activations in both
packages, with and without ragged lengths (bar 1e-5). The E-TDNN with each
attentive pooling is carried across by ``interop.from_jax`` and embeds the
same inputs in eval mode and in train mode, running statistics included
(bar 1e-4). Reference files written by the JAX package's
``save_reference_audio_checkpoint`` in both attentive layouts load through
the port's ``AudioExtractor.load_checkpoint`` (the ``SpeakerVerifier``'s
loader); the port's exports and its export CLI read back through the JAX
importer.

A constant channel has zero attentive variance, and ``sqrt(0)`` has the same
``inf · 0`` gradient in both packages; the inputs here have no constant
channel, but for the one test that pools one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.interop.torch_export import (export_speaker_embnet_state_dict,
                                              save_reference_audio_checkpoint)
from deeplip_tpu.interop.torch_import import import_speaker_embnet_state_dict
from deeplip_tpu.models import pooling as JP
from deeplip_tpu.models.tdnn import SpeakerEmbNet as JaxEmbNet
from deeplip_tpu_torch.cli import export_torch as cli_export
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.interop import torch_export as PE
from deeplip_tpu_torch.interop import torch_import as PI
from deeplip_tpu_torch.interop.from_jax import speaker_embnet_state_dict
from deeplip_tpu_torch.models import pooling as TP
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet
from deeplip_tpu_torch.train.audio import AudioExtractor

torch.set_num_threads(1)

ATTENTIVE = ["attentive_statistic", "mono_head_attention", "multi_head_attention"]
POOL_CLASSES = {"attentive_statistic": (JP.AttentiveStatPooling, TP.AttentiveStatPooling),
                "mono_head_attention": (JP.MonoHeadAttention, TP.MonoHeadAttention),
                "multi_head_attention": (JP.MultiHeadAttentivePooling,
                                         TP.MultiHeadAttentivePooling)}
CONTEXTS = [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]]
HIDDEN = [32, 32, 48]
EMB, HID = 16, 8


def _activations(b=4, t=30, c=48, seed=0):
    rng = np.random.default_rng(seed)
    # a per-channel offset and scale: no channel is constant
    return (rng.standard_normal((b, t, c)) * rng.uniform(0.5, 2.0, c)
            + rng.normal(0, 1, c)).astype(np.float32)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", ATTENTIVE)
def test_attentive_pooling_matches_jax(name, ragged):
    jcls, tcls = POOL_CLASSES[name]
    x = _activations()
    lengths = np.array([30, 17, 1, 24], np.int32) if ragged else None
    jmod = jcls(hidden_size=HID)
    jl = None if lengths is None else jnp.asarray(lengths)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jl)["params"])
    # the zero-initialised multi-head bias, randomised as training moves it
    params = {k: (np.random.default_rng(2).normal(0, 0.3, v.shape).astype(np.float32)
                  if k == "b" else v) for k, v in params.items()}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jl))
    pmod = tcls(x.shape[-1], HID)
    assert {k: tuple(v.shape) for k, v in pmod.state_dict().items()} == {
        k: v.shape for k, v in params.items()}
    pmod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    got = pmod(torch.from_numpy(x), None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    if ragged:
        # a padded row pools as the utterance alone
        alone = pmod(torch.from_numpy(x[1:2, :17]))
        np.testing.assert_allclose(got[1].detach().numpy(), alone[0].detach().numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_attentive_std_of_a_constant_channel():
    """``sqrt(max(sq − mean², 0))`` with no epsilon: a constant channel's
    std is the square root of the single-pass form's rounding, a few 1e-4
    at most, in either package (the order of the sums sets which); every
    other output agrees to 1e-5."""
    x = _activations(c=16)
    x[:, :, 3] = 0.7
    jmod = JP.AttentiveStatPooling(hidden_size=HID)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    pmod = TP.AttentiveStatPooling(16, HID)
    pmod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    got = pmod(torch.from_numpy(x)).detach().numpy()
    assert want[:, 16 + 3].max() <= 1e-3 and got[:, 16 + 3].max() <= 1e-3
    keep = np.arange(32) != 16 + 3
    np.testing.assert_allclose(got[:, keep], want[:, keep], atol=1e-5, rtol=1e-5)


def _jax_net(pooling, seed=0):
    model = JaxEmbNet(contexts=tuple(tuple(c) for c in CONTEXTS), hidden_dims=tuple(HIDDEN),
                      embedding_dim=EMB, pooling=pooling, attention_hidden_size=HID)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 40, 24), jnp.float32))
    params = jax.tree_util.tree_map(np.array, v["params"])
    stats = jax.tree_util.tree_map(np.array, v["batch_stats"])
    rng = np.random.default_rng(seed + 100)
    for name, sub in params.items():
        bn = sub.get("bn", sub) if isinstance(sub, dict) else None
        if bn is not None and "scale" in bn and "kernel" not in bn:
            bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.2, bn["bias"].shape).astype(np.float32)
            s = stats[name].get("bn", stats[name])
            s["mean"] = rng.normal(0, 0.5, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    if "b" in params.get("pool", {}):
        params["pool"]["b"] = rng.normal(0, 0.3, params["pool"]["b"].shape).astype(np.float32)
    return model, params, stats


def _port_net(pooling, params, stats):
    net = SpeakerEmbNet(CONTEXTS, HIDDEN, input_dim=24, embedding_dim=EMB, pooling=pooling,
                        attention_hidden_size=HID)
    net.load_state_dict(speaker_embnet_state_dict(params, stats), strict=True)
    return net


@pytest.mark.parametrize("pooling", ATTENTIVE)
def test_from_jax_equals_export(pooling):
    _, params, stats = _jax_net(pooling)
    got = speaker_embnet_state_dict(params, stats)
    want = export_speaker_embnet_state_dict(params, stats)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    width = 48 if pooling == "mono_head_attention" else 96
    assert _port_net(pooling, params, stats).fc1.in_features == width


@pytest.mark.parametrize("pooling", ATTENTIVE)
def test_etdnn_with_attentive_pooling_matches_jax(pooling):
    model, params, stats = _jax_net(pooling)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 40, 24)).astype(np.float32)
    lengths = np.array([40, 31, 12, 26], np.int32)
    net = _port_net(pooling, params, stats)
    variables = {"params": params, "batch_stats": stats}
    want = model.apply(variables, jnp.asarray(x), lengths=jnp.asarray(lengths),
                       method=model.extract_embedding)
    net.eval()
    got = net.extract_embedding(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    # train mode: the output and every updated running statistic
    out, upd = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net.train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    want_sd = export_speaker_embnet_state_dict(
        params, jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(net.state_dict()[k].numpy(), v, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def _audio_config(pooling):
    return Config({"model": {"arch": "tdnn", "tdnn": {
        "input_dim": 24, "hidden_dim": HIDDEN, "context": CONTEXTS,
        "tdnn_layers": len(CONTEXTS), "embedding_dim": EMB, "pooling": pooling,
        "attention_hidden_size": HID, "bn_first": True}},
        "data": {"python_data_config": {"rate": 16000, "feat_type": "mfcc"}}})


@pytest.mark.parametrize("layout", ["attentive_statistic", "mono_head_attention"])
def test_reference_pth_of_either_layout_loads(layout, tmp_path):
    """A reference file from the JAX package's saver, in the layout's own
    shapes, loads strictly through the extractor and embeds as JAX does."""
    model, params, stats = _jax_net(layout)
    path = str(tmp_path / "net_3.pth")
    save_reference_audio_checkpoint(path, params, stats, epoch=3, pooling=layout,
                                    data_parallel_prefix=True)
    raw = torch.load(path, weights_only=True)["state_dict"]
    assert raw["module.pooling.W"].ndim == (3 if layout == "mono_head_attention" else 2)
    ext = AudioExtractor(_audio_config(layout), device="cpu")
    ext.load_checkpoint(path)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 35, 24)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                       method=model.extract_embedding)[0]
    got = ext.model.extract_embedding(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["attentive_statistic", "mono_head_attention"])
def test_port_export_reads_back_through_the_jax_importer(layout, tmp_path, capsys):
    _, params, stats = _jax_net(layout)
    sd = speaker_embnet_state_dict(params, stats)
    ckpt = str(tmp_path / "net_avg")
    torch.save({"epoch": 2, "state_dict": sd, "criterion": {}}, ckpt)
    out = cli_export.main(["audio", "--checkpoint", ckpt, "--out", str(tmp_path / "o.pth"),
                           "--pooling", layout])
    assert "wrote" in capsys.readouterr().out
    tree = torch.load(out, weights_only=True)
    jp, js = import_speaker_embnet_state_dict(tree["state_dict"], n_blocks=len(CONTEXTS))
    for name in ("W", "b", "v", "k"):
        np.testing.assert_array_equal(jp["pool"][name], params["pool"][name], err_msg=name)
    np.testing.assert_array_equal(jp["fc1"]["kernel"], params["fc1"]["kernel"])
    # and back into the port: the same state dict
    back = PI.load_reference_audio_checkpoint(out)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_export_refuses_what_the_reference_cannot_hold():
    _, params, stats = _jax_net("multi_head_attention")
    multi = speaker_embnet_state_dict(params, stats)
    with pytest.raises(ValueError, match="multi-head"):
        PE.pooling_to_reference(multi, "attentive_statistic")
    _, params, stats = _jax_net("attentive_statistic")
    attentive = speaker_embnet_state_dict(params, stats)
    with pytest.raises(ValueError, match="layout"):
        PE.pooling_to_reference(attentive, "mono_head_attention")
    # no pooling parameters, or no layout asked for: the state dict as it is
    _, params, stats = _jax_net("statistic")
    plain = speaker_embnet_state_dict(params, stats)
    assert PE.pooling_to_reference(plain, "mono_head_attention").keys() == plain.keys()
    assert all(torch.equal(v, multi[k]) for k, v in
               PE.pooling_to_reference(multi, None).items())
    with pytest.raises(ValueError, match="TDNN"):
        PE.save_reference_audio_checkpoint("unused.pth", {"stem.weight": torch.ones(1)})
