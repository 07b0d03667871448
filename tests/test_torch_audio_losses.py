"""The port's training criteria against the JAX package's Flax modules.

Each criterion gets the same weights on both sides (the JAX init, carried
across by ``interop.from_jax.criterion_state_dict``) and the same
embeddings and labels. Loss, logits and the gradients with respect to the
embeddings and the weights are held to 1e-10 in f64 and 1e-5 in f32. The
cases cover LMCL at two margins, AAM-Softmax on both sides of its
``cos(π − m)`` switch and A-Softmax across every parity of ``k``. The
triplet strategies and the contrastive loss are held to 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.losses import softmax as JL
from deeplip_tpu.losses import triplet as JT
from deeplip_tpu_torch.interop.from_jax import criterion_state_dict
from deeplip_tpu_torch.losses import softmax as PL
from deeplip_tpu_torch.losses import triplet as PT

torch.set_num_threads(1)

B, D, C = 12, 16, 7
TOL = {"float64": 1e-10, "float32": 1e-5}


def _angled_embeddings(rng, w, labels, thetas):
    """Embeddings at angle ``thetas[i]`` from their target class's weight,
    with norms in [0.5, 2]."""
    wn = w / np.linalg.norm(w, axis=-1, keepdims=True)
    out = []
    for lab, th in zip(labels, thetas):
        u = rng.standard_normal(w.shape[1])
        u -= (u @ wn[lab]) * wn[lab]
        u /= np.linalg.norm(u)
        out.append((math.cos(th) * wn[lab] + math.sin(th) * u) * rng.uniform(0.5, 2.0))
    return np.stack(out)


def _case(name, dtype, seed=0):
    """The Flax criterion, its params, embeddings and labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, B)
    jmod = JL.build_criterion(name, C, scale=30.0, margin=0.2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype),
        jmod.init(jax.random.PRNGKey(seed), jnp.zeros((2, D)), jnp.zeros((2,), jnp.int32))["params"])
    if name == "CrossEntropy":
        emb = rng.standard_normal((B, D))
    else:
        # angles to the target class over (0, π): A-Softmax's k = floor(4θ/π)
        # takes every value 0..3, and the last rows sit past AAM's switch
        thetas = np.linspace(0.1, math.pi - 0.05, B)
        emb = _angled_embeddings(rng, np.asarray(params["weights"], np.float64), labels, thetas)
    return jmod, params, emb.astype(dtype), labels


def _jax_run(jmod, params, emb, labels, **kw):
    def f(p, e):
        loss, logits = jmod.apply({"params": p}, e, jnp.asarray(labels), **kw)
        return loss, logits

    (loss, logits), (gp, ge) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(emb))
    return float(loss), np.asarray(logits), np.asarray(ge), criterion_state_dict(
        jax.tree_util.tree_map(np.asarray, gp))


def _port_run(name, params, emb, labels, dtype, **kw):
    mod = PL.build_criterion(name, C, D, scale=30.0, margin=0.2).to(getattr(torch, dtype))
    mod.load_state_dict(criterion_state_dict(params), strict=True)
    e = torch.tensor(emb, requires_grad=True)
    loss, logits = mod(e, torch.tensor(labels), **kw)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    return float(loss.detach()), logits.detach().numpy(), e.grad.numpy(), grads


CASES = [("CrossEntropy", {}), ("LMCL", {"margin": 0.2}), ("LMCL", {"margin": 0.35}),
         ("AAM-Softmax", {"margin": 0.2}), ("AAM-Softmax", {"margin": 0.5}),
         ("A-Softmax", {}), ("A-Softmax", {"lam": 1.5})]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{kw}" for n, kw in CASES])
def test_criterion_matches_flax(name, kw, dtype):
    tol = TOL[dtype]
    with jax.enable_x64(dtype == "float64"):
        jmod, params, emb, labels = _case(name, dtype)
        want = _jax_run(jmod, params, emb, labels, **kw)
    got = _port_run(name, params, emb, labels, dtype, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol, err_msg="loss")
    np.testing.assert_allclose(got[1], want[1], rtol=tol, atol=tol, err_msg="logits")
    np.testing.assert_allclose(got[2], want[2], rtol=tol, atol=tol, err_msg="d embeddings")
    assert set(got[3]) == set(want[3])
    for k, v in want[3].items():
        np.testing.assert_allclose(got[3][k], v.numpy(), rtol=tol, atol=tol, err_msg=f"d {k}")


def test_cases_reach_every_branch():
    """The angled embeddings put AAM rows on both sides of ``cos(π − m)``
    and give A-Softmax every parity of k."""
    _, params, emb, labels = _case("A-Softmax", "float64")
    w = np.asarray(params["weights"])
    cos = np.sum(emb / np.linalg.norm(emb, axis=-1, keepdims=True)
                 * (w / np.linalg.norm(w, axis=-1, keepdims=True))[labels], axis=-1)
    k = np.floor(4 * np.arccos(np.clip(cos, -1 + 1e-7, 1 - 1e-7)) / math.pi)
    assert set(k.astype(int)) == {0, 1, 2, 3}
    for m in (0.2, 0.5):
        past = cos <= math.cos(math.pi - m)
        assert past.any() and (~past).any()


def test_lmcl_margin_is_a_call_argument_and_l1_is_added():
    mod = PL.LMCL(C, D, init_margin=0.2).double()
    e, lab = torch.randn(B, D, dtype=torch.float64), torch.arange(B) % C
    with torch.no_grad():
        l_default, logits = mod(e, lab)
        l_02, _ = mod(e, lab, margin=0.2)
        l_0, _ = mod(e, lab, margin=0.0)
    assert float(l_default) == float(l_02) and float(l_0) < float(l_02)
    ce = PL.softmax_cross_entropy(30.0 * logits, lab)
    l1 = 1e-5 * float(mod.weights.detach().abs().sum())
    assert float(l_0 - ce) == pytest.approx(l1, rel=1e-12)


def test_aam_gradients_stay_finite_at_alignment():
    mod = PL.AAMSoftmax(C, D).double()
    e = mod.weights.detach()[:3].clone().requires_grad_(True)   # cos = 1 exactly
    loss, _ = mod(e, torch.arange(3))
    loss.backward()
    assert torch.isfinite(e.grad).all() and torch.isfinite(mod.weights.grad).all()


def _triplet_data(seed=3, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int64))


@pytest.mark.parametrize("fn", ["batch_all_triplet_loss", "batch_hard_triplet_loss",
                                "semihard_triplet_loss", "contrastive_loss"])
def test_triplet_losses_match_jax(fn):
    emb, labels = _triplet_data()
    margin = 0.5 if fn == "contrastive_loss" else 0.2
    jl, jn = getattr(JT, fn)(jnp.asarray(emb), jnp.asarray(labels), margin)
    e = torch.tensor(emb, requires_grad=True)
    pl, pn = getattr(PT, fn)(e, torch.tensor(labels), margin)
    assert int(pn) == int(jn) > 1
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    pl.backward()
    jg = jax.grad(lambda x: getattr(JT, fn)(x, jnp.asarray(labels), margin)[0])(jnp.asarray(emb))
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("strategy", ["all", "hardest", "semihard"])
def test_online_triplet_strategies_match_jax(strategy):
    emb, labels = _triplet_data(seed=4)
    jl, jn = JT.OnlineTripletLoss(0.3, strategy)(jnp.asarray(emb), jnp.asarray(labels))
    pl, pn = PT.OnlineTripletLoss(0.3, strategy)(torch.tensor(emb), torch.tensor(labels))
    assert int(pn) == int(jn)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6, atol=1e-6)
