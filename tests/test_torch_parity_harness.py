"""The port's parity harness (``deeplip_tpu_torch/cli/parity_check.py``)
against ``scripts/parity_check.py``, and its bars on the CPU.

- its yardstick is the JAX harness's: ``numpy_mfcc`` bit-equal to
  ``benchmarks/reference_cpu_baseline.py``'s, and each torch replica
  (E-TDNN, its short pre-training, LMCL, CrossEntropy, Lipreading, LowFER)
  built from one seed with the same state dict and the same outputs as the
  JAX harness's function of that name (neither file imports JAX at module
  level);
- ``--selftest --device cpu`` and a reduced ``--full`` (4 speakers x 4
  utterances, 400 balanced trials, 8 pre-training steps, the E-TDNN at full
  width) meet the embedding bar (1e-4) and the EER bar (bit-equal);
- the four enforced train-parity cases at the JAX harness's defaults
  (CrossEntropy in f32, LMCL, video and fusion in f64) each drift at most
  1e-5, and the f32 video and fusion modes meet the f32 step rule, which
  a planted fault in K4's backward (dx scaled by 1.01) fails;
- the torch side of ``run_train_parity('LMCL', dtype='float64')`` is the
  JAX harness's, loss for loss, bit for bit;
- the float64 modes refuse a CUDA device; the exit codes.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.cli import parity_check as PC

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_harness():
    return _load("scripts/parity_check.py", "jax_parity_check")


@pytest.mark.parametrize("n", [1, 399, 400, 401, 16000, 24000])
def test_numpy_mfcc_is_the_baselines(n):
    base = _load("benchmarks/reference_cpu_baseline.py", "reference_cpu_baseline")
    sig = np.random.default_rng(n).standard_normal(n) * 0.1
    np.testing.assert_array_equal(PC.numpy_mfcc(sig), base.numpy_mfcc(sig))


def _sd_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _seeded(build, seed=0):
    torch.manual_seed(seed)
    return build()


def test_the_audio_replicas_are_the_jax_harness(jax_harness):
    spec = PC.ARCHS["tdnn"]
    assert PC.ARCHS == jax_harness.ARCHS
    dims = [24] + [32, 32, 64]
    ctx = spec["context"][:3]
    nets = [_seeded(lambda h=h: h.build_torch_net(torch, ctx, dims, 16))
            for h in (PC, jax_harness)]
    _sd_equal(nets[0].state_dict(), nets[1].state_dict())
    x = torch.randn(3, 24, 60, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(nets[0].extract(x), nets[1].extract(x))
        assert torch.equal(nets[0].train()(x), nets[1].train()(x))
    # the short pre-training: same steps, same weights after
    rng = np.random.default_rng(2)
    feats = {f"s{i}/u.wav": rng.standard_normal((120, 24)).astype(np.float32) for i in range(6)}
    labels = {name: i % 3 for i, name in enumerate(feats)}
    for net, h in zip(nets, (PC, jax_harness)):
        torch.manual_seed(3)
        h.train_torch_net(torch, net, feats, labels, 16, n_spk=3, steps=3, bs=4)
    _sd_equal(nets[0].state_dict(), nets[1].state_dict())
    emb, lab = torch.randn(4, 16), torch.tensor([0, 2, 1, 2])
    for build in ("build_torch_lmcl", "build_torch_ce"):
        args = (torch, 16, 3, 30.0) if build == "build_torch_lmcl" else (torch, 16, 3)
        crits = [_seeded(lambda h=h: getattr(h, build)(*args)) for h in (PC, jax_harness)]
        _sd_equal(crits[0].state_dict(), crits[1].state_dict())
        (l0, g0), (l1, g1) = (c(emb, lab) for c in crits)
        assert torch.equal(l0, l1) and torch.equal(g0, g1)


def test_the_video_and_fusion_replicas_are_the_jax_harness(jax_harness):
    nets = [_seeded(lambda h=h: h.build_torch_lipreading(torch, 5)) for h in (PC, jax_harness)]
    _sd_equal(nets[0].state_dict(), nets[1].state_dict())
    x = torch.randn(2, 1, 4, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(nets[0](x, [4, 3]), nets[1](x, [4, 3]))
    heads = [h.build_torch_lowfer(torch, 8, o=8, k=3, seed=4) for h in (PC, jax_harness)]
    _sd_equal(heads[0].state_dict(), heads[1].state_dict())
    e = torch.randn(3, 8, dtype=torch.float64)
    assert torch.equal(heads[0](e, e.flip(0)), heads[1](e, e.flip(0)))


def test_selftest_on_the_cpu(tmp_path):
    report = PC.main(["--selftest", "--device", "cpu", "--report", str(tmp_path / "r.json")])
    assert report["embedding_parity_bar_1e-4"] and report["max_embedding_abs_diff"] <= 1e-4
    assert (report["n_utterances"], report["n_trials"]) == (9, 100)
    assert json.loads((tmp_path / "r.json").read_text())["launches"]["fft"] == 0


def test_a_reduced_full_protocol_meets_both_bars():
    report = PC.main(["--full", "--device", "cpu", "--n-spk", "4", "--utts-per-spk", "4",
                      "--n-trials", "400", "--train-steps", "8"])
    assert report["max_embedding_abs_diff"] <= 1e-4
    assert report["eer_bit_equal"] and report["eer_reference_torch"] == report["eer_deeplip_tpu"]
    assert 0.0 < report["eer_reference_torch"] < 0.5
    assert report["order_flips"]["count"] == 0
    assert report["max_trial_score_abs_diff"] < 1e-5


@pytest.mark.parametrize("loss_name,dtype", [("CrossEntropy", "float32"), ("LMCL", "float64")])
def test_audio_train_parity_at_the_jax_defaults(loss_name, dtype):
    r = PC.run_train_parity(loss_name=loss_name, dtype=dtype)
    assert r["steps"] == 12 and r["param_drift_bar_1e-5"], r
    assert r["final_param_max_drift"] <= 1e-5 and r["final_batch_stats_max_drift"] <= 1e-5
    assert r["max_loss_abs_diff"] <= (1e-5 if dtype == "float32" else 1e-9)


def test_video_train_parity_in_float64():
    r = PC.run_video_train_parity(steps=10)
    assert r["param_drift_bar_1e-5"] and r["final_param_max_drift"] <= 1e-5, r
    assert r["final_batch_stats_max_drift"] <= 1e-5 and r["max_loss_abs_diff"] <= 1e-9


def test_fusion_train_parity_in_float64():
    r = PC.run_fusion_train_parity(steps=10)
    assert r["param_drift_bar_1e-5"] and r["final_param_max_drift"] <= 1e-5, r
    # LowFER's U and V get no gradient: torch's SGD leaves them alone, so must the port
    assert r["dead_param_max_drift"] == 0.0


@pytest.mark.parametrize("run", ["video", "fusion"])
def test_the_f32_step_rule_on_the_cpu(run):
    if run == "video":   # the input the card runs
        r = PC.run_video_train_parity(steps=10, dtype="float32", seed=PC.VIDEO_F32_SEED)
        assert r["first_grad_distance"] <= r["grad_distance_bar"] == PC.NUDGE_FACTOR * float(
            np.median(r["nudge_grad_distances"]))
    else:
        r = PC.run_fusion_train_parity(steps=10, dtype="float32")
    assert r["f32_step_rule"], r
    assert len(r["nudge_param_distances"]) == PC.NUDGES
    assert r["param_distance_bar"] == PC.NUDGE_FACTOR * float(
        np.median(r["nudge_param_distances"]))
    assert r["loss_rel_bar"] >= PC.STEP_LOSS_RTOL
    assert r["first_loss_rel_diff"] <= PC.STEP_LOSS_RTOL


def test_the_f32_step_rule_fails_a_planted_k4_fault(monkeypatch):
    """K4's dx scaled by 1.01: Adam is nearly blind to it in the losses and
    the parameters, the first-step gradients are not."""
    from deeplip_tpu_torch.ops.cuda import bn_prelu
    k4 = bn_prelu.bn_prelu_backward

    def faulty(*args, **kwargs):
        dx, *rest = k4(*args, **kwargs)
        return (dx * 1.01, *rest)

    monkeypatch.setattr(bn_prelu, "bn_prelu_backward", faulty)
    r = PC.run_video_train_parity(steps=10, dtype="float32", seed=PC.VIDEO_F32_SEED)
    assert not r["f32_step_rule"], r
    assert r["first_grad_distance"] > 100 * r["grad_distance_bar"], r


def test_the_cli_runs_the_train_parity_modes(tmp_path, capsys):
    out = tmp_path / "tp.json"
    reports = PC.main(["--train-parity", "--device", "cpu", "--train-steps", "4",
                       "--report", str(out)])
    assert set(reports) >= {"CrossEntropy_float32", "LMCL_float64", "LMCL_float32", "launches"}
    assert not reports["LMCL_float32"]["enforced"]
    assert json.loads(out.read_text())["LMCL_float64"]["steps"] == 4
    r = PC.main(["--train-parity-fusion", "--device", "cpu", "--train-steps", "2"])
    assert r["kind"] == "fusion" and r["steps"] == 2


def test_float64_refuses_the_card_and_a_missed_bar_exits_3(monkeypatch):
    with pytest.raises(ValueError, match="runs on the CPU"):
        PC._require_f64_on_cpu("float64", torch.device("cuda"), "the video train parity")
    PC._require_f64_on_cpu("float32", torch.device("cuda"), "the video train parity")
    monkeypatch.setattr(PC, "DRIFT_BAR", 0.0)
    with pytest.raises(SystemExit) as exc:
        PC.main(["--train-parity-video", "--device", "cpu", "--train-steps", "2"])
    assert exc.value.code == 3


def test_order_flips_finds_the_pairs_an_eer_can_tell_apart():
    labels = np.array([1, 0, 1, 0, 0])
    ref = np.array([0.50, 0.49, 0.90, 0.10, 0.4999999])
    ours = ref + np.array([-0.02, 0.0, 0.0, 0.0, 0.0])
    flips = PC.order_flips(labels, ref, ours)
    assert flips["count"] == 2
    assert {(f["target"], f["nontarget"]) for f in flips["first"]} == {(0, 1), (0, 4)}
    assert PC.order_flips(labels, ref, ref)["count"] == 0


def test_the_torch_side_is_the_jax_harness_bit_for_bit(jax_harness):
    """The JAX harness's own run (its JIT compile included) and the port's
    run of ``run_train_parity('LMCL', dtype='float64')``: the reference
    replica's per-step losses are the same numbers."""
    want = jax_harness.run_train_parity(loss_name="LMCL", dtype="float64")
    got = PC.run_train_parity(loss_name="LMCL", dtype="float64")
    assert got["torch_losses"] == want["torch_losses"]
    np.testing.assert_allclose(got["deeplip_losses"], want["deeplip_losses"], rtol=1e-9)
