"""The ECAPA-TDNN cell (``ecapa-train-f32``) on the CPU at a small size: its
driver (``audio_train``) runs ``AudioTrainer.train_step`` on ``arch: ecapa``
through the harness, the sound run reads small gaps against the plain
reference, and a run with a fault planted in the program reads large ones
(the pattern of ``test_perfbench_fusion.py``, with the cell narrowed here)."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from perfbench import harness

CELL = "ecapa-train-f32"
torch.set_num_threads(2)


def tiny_ecapa_cell() -> harness.Cell:
    """The cell's files, read and then cut: 64 channels in eight groups,
    16-wide SE and attention, a 96-wide aggregation, a 16-wide embedding,
    five classes, six crops a step from a pool of sixteen. The crops keep
    their 200 frames and the front-end its MFCC-80."""
    cell = harness.load_cell(CELL)
    config, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    config["model"]["ecapa"].update(channels=64, se_channels=16, attention_channels=16,
                                    mfa_channels=96, embedding_dim=16)
    config["num_classes"] = 5
    t.update(batch=6, pool=16, pool_seconds=4.5, max_steps=32)
    return harness.Cell(CELL, cell.spec, config, t)


SEED = 2 ** 31 + 91


def run(seed: int = SEED, trace: bool = False, limits: dict | None = None) -> dict:
    cell = tiny_ecapa_cell()
    cell.spec = {**cell.spec, "limits": limits or {}}
    bench = harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
    e2e, per_layer = harness.cell_metrics(bench, cell)
    return harness.execute(cell, e2e, per_layer, seed, 0.5, trace, torch.device("cpu"),
                           time.perf_counter())


@pytest.fixture(scope="module")
def sound():
    return {n: c["value"] for n, c in run()["checks"].items()}


@pytest.fixture(scope="module")
def rounding():
    """The reference in float32 against itself in float64, on the cell's
    weights and first batches: what float32 rounding alone reads."""
    from perfbench import compare, weights
    from perfbench.reference.etdnn_vox12 import as_samples

    cell = tiny_ecapa_cell()
    ctx = harness.Context(cell, SEED, torch.device("cpu"))
    driver = harness.load_module(harness.BENCH_DIR / "drivers" / "audio_train.py",
                                 "perfbench_driver_audio_train").Driver(ctx)
    driver.prepare()
    f32 = driver.reference_readings("f32")
    model = driver._reference_model().double()
    state = weights.seeded_state(weights.shapes_of(model), ctx.seed_for(0), ctx.device)
    model.load_state_dict({k: v.double() if v.is_floating_point() else v
                           for k, v in state.items()})
    batches = [(as_samples(pcm).double(), labels)
               for pcm, labels in (driver.batch(i) for i in range(3))]
    f64 = ctx.reference().train_steps(model, batches, driver.config, "f32")
    return dict(compare.train_numbers(f32, f64))


def test_the_benchmark_lists_the_cell_and_its_metrics():
    bench = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cell = harness.load_cell(CELL)
    assert (cell.spec["config"], cell.spec["traffic"], cell.spec["driver"]) == (
        "ecapa-tdnn-c1024", "crops-200-f32", "audio_train")
    e2e, per_layer = harness.cell_metrics(bench, cell)
    assert {m["name"] for m in e2e} == {"train_samples_per_s", "setup_s"}
    assert {"ecapa_res2net_ms.train", "ecapa_se_ms.train", "ecapa_pool_ms.train",
            "mfu.train", "peak_mem_gib.train", "step_ms_p95.train"} <= {
        m["name"] for m in per_layer}
    assert set(cell.spec["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert cell.config["reduced"] == [] and cell.config["num_classes"] == 5994


def test_the_sound_run_reads_rounding_alone(sound, rounding):
    """float32 on the CPU against the float32 reference reads no more than
    three times what the reference's own float32 reads against its float64.
    At these narrow widths that is far from nought: train-mode BN over
    nearly dead ReLU channels amplifies rounding in the Res2Net chains'
    gradients (about 5e-3 of the median leaf), and Adam's first updates,
    near ``lr · sign(g)``, carry it into steps 2 and 3 (about 1e-2 of the
    loss); the first step's loss agrees to about 1e-6."""
    assert set(sound) >= {"loss_gap", "first_loss_gap", "grad_gap", "change_gap"}
    for name in ("loss_gap", "first_loss_gap", "grad_gap", "change_gap"):
        assert sound[name] <= 3 * max(rounding[name], 1e-6), (name, sound, rounding)
    result = run(limits={n: max(3 * v, 1e-9) for n, v in sound.items()})
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0


def _half_batch(monkeypatch):
    """The loss over the first half of the rows, weighted up to the whole."""
    from deeplip_tpu_torch.losses import softmax

    cross_entropy = softmax.softmax_cross_entropy

    def half(logits, labels, reduction="mean"):
        per = cross_entropy(logits, labels, reduction="none")
        h = max(per.shape[0] // 2, 1)
        weight = torch.zeros_like(per)
        weight[:h] = per.shape[0] / h
        return (per * weight).mean() if reduction == "mean" else per * weight

    monkeypatch.setattr(softmax, "softmax_cross_entropy", half)


def _frozen_state(monkeypatch):
    from deeplip_tpu_torch.train import state

    monkeypatch.setattr(state.Adam, "step", lambda self, lr=None: None)


def _no_se_gate(monkeypatch):
    """Every block's gate held at 1: ``b + u``."""
    from deeplip_tpu_torch.models import ecapa

    monkeypatch.setattr(ecapa.SEGate, "forward", lambda self, b, mask, count: torch.ones_like(
        b[..., :1]))


def _no_global_context(monkeypatch):
    """The attention scored on the frames alone, ``μ_g`` and ``σ_g`` as 0."""
    from deeplip_tpu_torch.models import ecapa

    def pooled(self, h, mask, count):
        zeros = torch.zeros_like(h)
        scores = ecapa._conv(self.conv, torch.tanh(self.tdnn(torch.cat([h, zeros, zeros], 1))))
        alpha = torch.softmax(scores, dim=-1)
        mu = (alpha * h).sum(dim=-1)
        return torch.cat([mu, ecapa._std((alpha * h * h).sum(dim=-1), mu)], dim=-1)

    monkeypatch.setattr(ecapa.AttentivePooling, "forward", pooled)


@pytest.mark.parametrize("fault,moved", [
    (_half_batch, ("first_loss_gap", "grad_gap")), (_frozen_state, ("change_gap",)),
    (_no_se_gate, ("first_loss_gap", "grad_gap")),
    (_no_global_context, ("first_loss_gap", "grad_gap"))],
    ids=["half_batch", "state_unchanged", "no_se_gate", "no_global_context"])
def test_a_planted_fault_reads_large_gaps(fault, moved, sound, monkeypatch):
    """Each fault reads at least ten times the sound run (at these widths
    the sound ``grad_gap`` and ``change_gap`` carry the rounding above)."""
    fault(monkeypatch)
    result = run(limits={n: max(3 * v, 1e-9) for n, v in sound.items()})
    assert result["correct"] is False
    for name in moved:
        assert result["checks"][name]["value"] > 10 * max(sound[name], 1e-7), (
            name, result["checks"])


def test_a_traced_run_reads_the_spans_it_can():
    """On the CPU the spans have host time only: the step's host time is
    read, and the three ECAPA spans' device times are left out, not
    raised."""
    metrics = run(trace=True)["metrics"]
    assert metrics["host_ms.train"]["value"] > 0
    assert not {"ecapa_res2net_ms.train", "ecapa_se_ms.train", "ecapa_pool_ms.train"} & set(
        metrics)
