"""The fusion heads of the port against the JAX package's Flax modules with
carried weights (1e-5: a few f32 matmuls and a sigmoid), their state-dict
layouts, and the z-norm of the test-time concat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.interop.torch_export import export_lowfer_state_dict
from deeplip_tpu.models import fusion as JF
from deeplip_tpu.train.fusion import _znorm as jax_znorm
from deeplip_tpu_torch.interop.from_jax import linear_fusion_state_dict, lowfer_state_dict
from deeplip_tpu_torch.models.fusion import LinearFusion, LowFER
from deeplip_tpu_torch.train.fusion import _znorm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _pair(d1, d2, seed, b=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d1)).astype(np.float32),
            rng.standard_normal((b, d2)).astype(np.float32))


@pytest.mark.parametrize("dims", [(16, 16), (16, 24)])
def test_lowfer_matches(dims):
    e1, e2 = _pair(*dims, seed=0)
    head = JF.LowFER(input_dims=dims, k=3, output_dim=8)
    variables = head.init(jax.random.PRNGKey(1), jnp.asarray(e1), jnp.asarray(e2))
    params = _np_tree(variables["params"])
    want = np.asarray(head.apply(variables, jnp.asarray(e1), jnp.asarray(e2)))
    want_mfb = np.asarray(head.apply(variables, jnp.asarray(e1), jnp.asarray(e2),
                                     method=head.mfb))
    net = LowFER(input_dims=dims, k=3, output_dim=8).eval()
    net.load_state_dict(lowfer_state_dict(params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
        got_mfb = net.mfb(torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
    assert got.shape == want.shape == (5, 3 * dims[0])
    np.testing.assert_allclose(got, want, **TOL)
    assert got_mfb.shape == want_mfb.shape == (5, 8)
    np.testing.assert_allclose(got_mfb, want_mfb, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got_mfb, axis=-1), 1.0, atol=1e-5)


def test_lowfer_state_dict_equals_export():
    head = JF.LowFER(input_dims=(8, 8), k=2, output_dim=4)
    e = jnp.zeros((1, 8))
    params = _np_tree(head.init(jax.random.PRNGKey(0), e, e)["params"])
    got, want = lowfer_state_dict(params), export_lowfer_state_dict(params)
    assert list(got) == list(want) == ["U", "V"]
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    net = LowFER(input_dims=(8, 8), k=2, output_dim=4)
    assert list(net.state_dict()) == ["U", "V"]
    net.load_state_dict(got, strict=True)


def test_lowfer_output_never_sees_u_and_v():
    net = LowFER(input_dims=(6, 6), k=2, output_dim=4)
    e1, e2 = (torch.from_numpy(a).requires_grad_(True) for a in _pair(6, 6, seed=2))
    net(e1, e2).sum().backward()
    assert net.U.grad is None and net.V.grad is None and e1.grad is not None
    lo, hi = float(net.U.detach().min()), float(net.U.detach().max())
    assert -1.0 <= lo < -0.5 and 0.5 < hi <= 1.0   # uniform(-1, 1) init


@pytest.mark.parametrize("extract_feats", [True, False])
def test_linear_fusion_matches(extract_feats):
    e1, e2 = _pair(10, 14, seed=3)
    x = np.concatenate([e1, e2], axis=-1)
    head = JF.LinearFusion(hidden_size=12, extract_feats=extract_feats)
    variables = _np_tree(head.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    rng = np.random.default_rng(5)
    bn_p, bn_s = variables["params"]["bn1"], variables["batch_stats"]["bn1"]
    bn_p["scale"] = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bn_p["bias"] = rng.normal(0, 0.2, 12).astype(np.float32)
    bn_s["mean"] = rng.normal(0, 0.5, 12).astype(np.float32)
    bn_s["var"] = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    want = np.asarray(head.apply(variables, jnp.asarray(x)))
    net = LinearFusion(24, hidden_size=12, extract_feats=extract_feats).eval()
    net.load_state_dict(linear_fusion_state_dict(variables["params"],
                                                 variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 12)
    np.testing.assert_allclose(got, want, **TOL)


def test_znorm_matches_population_std():
    x = _pair(32, 32, seed=6)[0] * 3.0 + 1.5
    want = np.asarray(jax_znorm(jnp.asarray(x)))
    got = _znorm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.std(axis=-1), 1.0, atol=1e-5)   # ddof 0
    np.testing.assert_allclose(got.mean(axis=-1), 0.0, atol=1e-5)
