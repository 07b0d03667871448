"""The span readers (``metrics/_spans.py`` and the eight ``*_ms.train`` /
``*_ms.score`` files) in a traced run on the CPU: the host time of the
step or embedding spans is reported per unit, and the device-time metrics
are left out (no card, no events); a program without spans reports none."""

from __future__ import annotations

import sys

import pytest

from perfbench.tests import tiny

DEVICE = ("input_ms", "forward_ms", "backward_ms", "optimizer_ms")


@pytest.fixture
def fresh_spans():
    from deeplip_tpu_torch.core import spans

    spans.reset()
    yield spans
    spans.reset()


@pytest.mark.parametrize("cell,kind,span,per_unit", [
    ("etdnn-train-bf16", "train", "deeplip.step", 1),
    ("etdnn-score-3s", "score", "deeplip.embed", 3)])   # tiny lists: 20 rows in batches of 8
def test_a_traced_run_reports_host_time_per_unit(cell, kind, span, per_unit, fresh_spans):
    result = tiny.run_tiny(cell, seconds=0.3, trace=True)
    metrics = result["metrics"]
    got = fresh_spans.totals()[span]
    assert got["count"] == per_unit * result["attempted"] > 0
    assert metrics[f"host_ms.{kind}"]["value"] == pytest.approx(
        got["host_ms"] / result["attempted"])
    assert metrics[f"host_ms.{kind}"]["unit"] == "ms"
    assert not {f"{m}.{kind}" for m in DEVICE} & set(metrics)


def test_a_program_without_spans_reports_none(monkeypatch, fresh_spans):
    monkeypatch.setitem(sys.modules, "deeplip_tpu_torch.core.spans", None)
    result = tiny.run_tiny("etdnn-train-bf16", seconds=0.3, trace=True)
    assert result["attempted"] > 0
    assert not {"host_ms.train", *(f"{m}.train" for m in DEVICE)} & set(result["metrics"])
