"""The port's TensorBoard event writer against the JAX package's, byte for
byte, with the clock and the host name held fixed; the CRC32C values; the
trainers' ``StepLogger`` writing ``<exp_dir>/tb``; and ``profile_trace``."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deeplip_tpu.train import tb_events as jax_tb
from deeplip_tpu_torch.core import spans
from deeplip_tpu_torch.train import metrics, tb_events

torch.set_num_threads(1)


def _fixed(monkeypatch, module, now=1700000000.25, host="card-host"):
    monkeypatch.setattr(module.time, "time", lambda: now)
    monkeypatch.setattr(module.socket, "gethostname", lambda: host)


def _write(module, logdir):
    w = module.TBEventWriter(str(logdir))
    w.add_scalars(0, {"train/loss": 3.25, "train/acc": 0.5})
    w.add_scalars(7, {"train/lr": 1e-3}, wall_time=1700000001.5)
    w.add_scalars(2 ** 40, {"video/loss": float(np.float32(0.1))})
    w.add_scalars(-1, {"neg/step": -2.0})
    w.add_scalars(9, {})          # writes nothing
    w.close()
    w.close()                     # idempotent
    return w.path


def test_event_file_bytes_equal_the_jax_writer(tmp_path, monkeypatch):
    _fixed(monkeypatch, tb_events)
    _fixed(monkeypatch, jax_tb)
    got, want = _write(tb_events, tmp_path / "p"), _write(jax_tb, tmp_path / "j")
    assert os.path.basename(got) == os.path.basename(want) == (
        "events.out.tfevents.1700000000.card-host")
    with open(got, "rb") as a, open(want, "rb") as b:
        data = a.read()
        assert data == b.read()
    # every record's CRC checks, and the scalars read back
    records = chip_smoke.read_tb_scalars(got)
    assert [step for step, _ in records] == [0, 0, 7, 2 ** 40, 2 ** 64 - 1]
    assert records[1][1] == {"train/loss": 3.25, "train/acc": 0.5}
    assert records[2][1] == {"train/lr": pytest.approx(1e-3)}
    # a flipped payload byte fails its CRC
    bad = tmp_path / "bad"
    bad.write_bytes(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(chip_smoke.SmokeFailure, match="CRC"):
        chip_smoke.read_tb_scalars(str(bad))


@pytest.mark.parametrize("payload,crc", [(b"", 0x0), (b"a", 0xC1D04330),
                                         (b"123456789", 0xE3069283),
                                         (bytes(32), 0x8A9136AA)])
def test_crc32c_values(payload, crc):
    assert tb_events._crc32c(payload) == jax_tb._crc32c(payload) == crc
    assert tb_events._masked_crc(payload) == jax_tb._masked_crc(payload)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 2 ** 31, 2 ** 64 - 1])
def test_varints_equal_jax(n):
    assert tb_events._varint(n) == jax_tb._varint(n)


def test_step_logger_writes_tensorboard_beside_the_json_records(tmp_path, monkeypatch):
    _fixed(monkeypatch, tb_events)
    _fixed(monkeypatch, jax_tb)
    ticks = iter(range(100))
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: float(next(ticks)))
    from deeplip_tpu.train import metrics as jax_metrics
    jticks = iter(range(100))
    monkeypatch.setattr(jax_metrics.time, "perf_counter", lambda: float(next(jticks)))
    for module, tag in ((metrics, "p"), (jax_metrics, "j")):
        logger = module.StepLogger(str(tmp_path / tag), print_every=0, prefix="video")
        logger.log(2, examples=8, loss=1.5, acc=0.25)
        logger.log(4, examples=8, loss=np.float32(1.25), epoch=1)
        logger.close()
    names = {tag: sorted(os.listdir(tmp_path / tag)) for tag in "pj"}
    assert names["p"] == names["j"] == ["tb", "video_metrics.jsonl"]
    files = {tag: os.path.join(tmp_path, tag, "tb", os.listdir(tmp_path / tag / "tb")[0])
             for tag in "pj"}
    with open(files["p"], "rb") as a, open(files["j"], "rb") as b:
        assert a.read() == b.read()
    records = chip_smoke.read_tb_scalars(files["p"])
    with open(tmp_path / "p" / "video_metrics.jsonl") as fh:
        losses = {r["step"]: r["loss"] for r in map(json.loads, fh)}
    assert {s: v["video/loss"] for s, v in records if "video/loss" in v} == losses
    # tensorboard=False and no exp dir write no event file
    metrics.StepLogger(str(tmp_path / "off"), tensorboard=False).close()
    assert os.listdir(tmp_path / "off") == ["train_metrics.jsonl"]
    metrics.StepLogger(None).log(1, loss=1.0)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with metrics.profile_trace(None):
        with spans.span("deeplip.forward"):
            torch.ones(3).sum()
    with metrics.profile_trace(str(tmp_path / "trace")):
        with spans.span("deeplip.forward"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as fh:
        trace = json.load(fh)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::mm", "deeplip.forward"} <= names
    # the region's span totals beside the trace; the span outside any
    # region recorded nothing
    with open(tmp_path / "trace" / "spans.json") as fh:
        totals = json.load(fh)
    assert set(totals) == {"deeplip.forward"}
    forward = totals["deeplip.forward"]
    assert forward["count"] == 1 and forward["device_ms"] is None
    assert 0 < forward["self_host_ms"] == forward["host_ms"]
