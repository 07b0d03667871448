"""The fusion cell (``fusion-train-f32``) on the CPU at a small size: its
driver runs ``FusionTrainer.train_step`` through the harness, the sound run
reads small gaps against the plain reference, and a run with a fault
planted in the program reads large ones (the pattern of
``test_perfbench_faults.py``, with the cell narrowed here: ``tiny.py``
narrows the other configurations)."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from perfbench import harness

CELL = "fusion-train-f32"
torch.set_num_threads(2)


def tiny_fusion_cell() -> harness.Cell:
    """The cell's files, read and then cut: a thin E-TDNN that keeps the
    512-wide embedding (LowFER's inputs stay equal), a one-level TCN that
    the frame path never runs, a 24-pixel crop of four-frame clips, six
    items a step from a pool of twelve."""
    cell = harness.load_cell(CELL)
    config, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    config["model"]["audio_config"]["etdnn"]["hidden_dim"] = [16] * 9 + [24]
    config["model"]["video_config"]["tcn"]["tcn_num_layers"] = 1
    config.update(num_classes=5, video_hidden_dim=4, crop=24)
    t.update(batch=6, pool=12, pool_seconds=4.5, max_steps=32, clip_frames=4, height=32,
             width=32, short_frames=[2, 3], short_share=0.5)
    return harness.Cell(CELL, cell.spec, config, t)


def run(seed: int = 2 ** 31 + 77, trace: bool = False, limits: dict | None = None) -> dict:
    cell = tiny_fusion_cell()
    cell.spec = {**cell.spec, "limits": limits or {}}
    bench = harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
    e2e, per_layer = harness.cell_metrics(bench, cell)
    return harness.execute(cell, e2e, per_layer, seed, 0.5, trace, torch.device("cpu"),
                           time.perf_counter())


@pytest.fixture(scope="module")
def sound():
    return {n: c["value"] for n, c in run()["checks"].items()}


def test_the_sound_run_reads_small_gaps(sound):
    """float32 on the CPU against the float32 reference: rounding alone."""
    assert set(sound) >= {"loss_gap", "grad_gap", "change_gap", "audio_emb_gap",
                          "video_emb_gap"}
    assert all(v < 1e-4 for v in sound.values()), sound
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
        return per * weight

    monkeypatch.setattr(softmax, "softmax_cross_entropy", half)


def _frozen_state(monkeypatch):
    from deeplip_tpu_torch.train import state

    monkeypatch.setattr(state.SGD, "step", lambda self, lr=None: None)


def _altered_frames(monkeypatch):
    """The video encoder's frame embeddings a thousandth off."""
    from deeplip_tpu_torch.models.lipreading import Lipreading

    frames = Lipreading.frame_features
    monkeypatch.setattr(Lipreading, "frame_features",
                        lambda self, x, dtype=None: 1.001 * frames(self, x, dtype))


@pytest.mark.parametrize("fault,moved", [
    (_half_batch, ("loss_gap", "grad_gap")), (_frozen_state, ("change_gap",)),
    (_altered_frames, ("video_emb_gap",))], ids=["half_batch", "state_unchanged",
                                                 "frames_altered"])
def test_a_planted_fault_reads_large_gaps(fault, moved, sound, monkeypatch):
    fault(monkeypatch)
    result = run(limits={n: max(3 * v, 1e-9) for n, v in sound.items()})
    assert result["correct"] is False
    for name in moved:
        assert result["checks"][name]["value"] > 100 * max(sound[name], 1e-7), (
            name, result["checks"])


def test_a_traced_run_reads_the_spans_it_can():
    """On the CPU the spans have host time only: the step's host time is
    read, and the two encoders' device times are left out, not raised."""
    metrics = run(trace=True)["metrics"]
    assert metrics["host_ms.train"]["value"] > 0
    assert "encode_video_ms.train" not in metrics and "encode_audio_ms.train" not in metrics
