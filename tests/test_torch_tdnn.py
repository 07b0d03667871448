"""The port's E-TDNN against the JAX package's, with weights carried across.

A small network (5 blocks of 64 channels, embedding 32) is initialised in
JAX with randomised BN parameters and running statistics, carried into the
port by ``interop.from_jax``, and both embed the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.interop.torch_export import export_speaker_embnet_state_dict
from deeplip_tpu.models import pooling as JP
from deeplip_tpu.models.tdnn import SpeakerEmbNet as JaxEmbNet
from deeplip_tpu.models.tdnn import context_to_kernel as jax_context_to_kernel
from deeplip_tpu_torch.interop.from_jax import speaker_embnet_state_dict
from deeplip_tpu_torch.models import pooling as TP
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet, context_to_kernel

torch.set_num_threads(1)

CONTEXTS = [[-2, -1, 0, 1, 2], [-2, 0, 2], [-3, 0, 3], [0], [0]]
HIDDEN = [64, 64, 64, 64, 64]
EMB = 32


def _randomise_bn(tree, stats, rng):
    """Non-trivial BN scale/bias and running stats, in place of the init's
    ones and zeros."""
    for name, sub in tree.items():
        if isinstance(sub, dict) and "scale" in sub:
            c = sub["scale"].shape
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            stats[name]["mean"] = rng.normal(0, 0.5, c).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        elif isinstance(sub, dict):
            _randomise_bn(sub, stats.setdefault(name, {}), rng)


def _jax_net(bn_first=True, pooling="statistic", seed=0):
    model = JaxEmbNet(contexts=tuple(tuple(c) for c in CONTEXTS),
                      hidden_dims=tuple(HIDDEN), embedding_dim=EMB,
                      pooling=pooling, bn_first=bn_first)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 60, 24), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    _randomise_bn(params, stats, np.random.default_rng(seed + 100))
    return model, params, stats


def _port_net(params, stats, bn_first=True, pooling="statistic"):
    net = SpeakerEmbNet(CONTEXTS, HIDDEN, input_dim=24, embedding_dim=EMB,
                        pooling=pooling, bn_first=bn_first).eval()
    net.load_state_dict(speaker_embnet_state_dict(params, stats), strict=True)
    return net


def test_from_jax_equals_export():
    _, params, stats = _jax_net()
    got = speaker_embnet_state_dict(params, stats)
    want = export_speaker_embnet_state_dict(params, stats, pooling="statistic")
    assert list(got) == list(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_state_dict_layout_matches_reference():
    net = SpeakerEmbNet(CONTEXTS, HIDDEN, input_dim=24, embedding_dim=EMB)
    _, params, stats = _jax_net()
    want = export_speaker_embnet_state_dict(params, stats, pooling="statistic")
    assert set(net.state_dict()) == set(want)
    for k, v in net.state_dict().items():
        assert tuple(v.shape) == want[k].shape, k


@pytest.mark.parametrize("bn_first", [True, False])
@pytest.mark.parametrize("pooling", ["statistic", "average"])
def test_embeddings_match(bn_first, pooling):
    model, params, stats = _jax_net(bn_first=bn_first, pooling=pooling, seed=1)
    net = _port_net(params, stats, bn_first=bn_first, pooling=pooling)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 80, 24)).astype(np.float32)
    lengths = np.array([80, 61, 45], np.int32)
    variables = {"params": params, "batch_stats": stats}
    for lens in (None, lengths):
        jl = None if lens is None else jnp.asarray(lens)
        tl = None if lens is None else torch.from_numpy(lens)
        want_xv, want_xa = model.apply(variables, jnp.asarray(x), lengths=jl,
                                       method=model.extract_embedding)
        with torch.no_grad():
            got_xv, got_xa = net.extract_embedding(torch.from_numpy(x), lengths=tl)
            got_out = net(torch.from_numpy(x), lengths=tl)
        want_out = model.apply(variables, jnp.asarray(x), lengths=jl)
        np.testing.assert_allclose(got_xv.numpy(), np.asarray(want_xv), atol=1e-4)
        np.testing.assert_allclose(got_xa.numpy(), np.asarray(want_xa), atol=1e-4)
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=1e-4)


def test_padded_rows_equal_exact_length():
    """VALID convs + masked pooling: a padded row embeds as its exact-length
    self."""
    _, params, stats = _jax_net(seed=2)
    net = _port_net(params, stats)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 90, 24)).astype(np.float32)
    with torch.no_grad():
        padded, _ = net.extract_embedding(torch.from_numpy(x),
                                          lengths=torch.tensor([90, 57]))
        exact, _ = net.extract_embedding(torch.from_numpy(x[1:, :57]))
    np.testing.assert_allclose(padded[1].numpy(), exact[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["MeanStdPooling", "AveragePooling"])
def test_masked_pooling_matches(name):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 40, 16)).astype(np.float32) + 1.5
    lengths = np.array([40, 1, 23], np.int32)
    jmod = getattr(JP, name)()
    tmod = getattr(TP, name)()
    for lens in (None, lengths):
        want = jmod.apply({}, jnp.asarray(x),
                          lengths=None if lens is None else jnp.asarray(lens))
        got = tmod(torch.from_numpy(x),
                   lengths=None if lens is None else torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_receptive_field_and_kernels():
    model, _, _ = _jax_net()
    net = SpeakerEmbNet(CONTEXTS, HIDDEN, input_dim=24, embedding_dim=EMB)
    assert net.receptive_field == model.receptive_field
    for ctx in CONTEXTS:
        assert context_to_kernel(ctx) == jax_context_to_kernel(ctx)
    lens = torch.tensor([10, 30, 5])
    assert net.valid_lengths(lens).tolist() == np.asarray(
        model.valid_lengths(jnp.asarray(lens.numpy()))).tolist()


def test_batchnorm_train_mode_is_not_ported():
    """Train mode on a 3-D input: two-pass batch statistics normalise the
    input, the running statistics take torch's Bessel-corrected update, and
    the state dict keeps the reference keys."""
    bn = TorchBatchNorm(4)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) ** 1.5
    y = bn(x)
    flat = x.reshape(-1, 4)
    torch.testing.assert_close(y.reshape(-1, 4).mean(0), torch.zeros(4), atol=1e-5, rtol=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * flat.mean(0))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * flat.var(0, unbiased=True))
    assert int(bn.num_batches_tracked) == 1
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var", "num_batches_tracked"}
