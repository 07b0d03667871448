"""The port's spans (``deeplip_tpu_torch.core.spans``): a shared no-op while
no profiler runs; under one, ``record_function`` ranges nested as the code
nests them and a registry of totals by name (count, host time, self host
time, device time from CUDA events, none while a graph is captured); and
one span of each phase in a CPU step of each trainer and in an embedding
batch, which compute what they compute without a profiler."""

import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeplip_tpu_torch.core import spans
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.train.audio import AudioExtractor, AudioTrainer
from deeplip_tpu_torch.train.fusion import FusionTrainer
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(1)

STEP = ("deeplip.step", "deeplip.input", "deeplip.forward", "deeplip.backward",
        "deeplip.optimizer")
FUSION_STEP = ("deeplip.step", "deeplip.input", "deeplip.encode.audio", "deeplip.encode.video",
               "deeplip.forward", "deeplip.backward", "deeplip.optimizer")
ECAPA = ("deeplip.ecapa.res2net", "deeplip.ecapa.se", "deeplip.ecapa.pool")


@pytest.fixture(autouse=True)
def _fresh_registry():
    spans.reset()
    yield
    spans.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _deeplip_events(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("deeplip.")]


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    assert set(FUSION_STEP) | {"deeplip.embed"} | set(ECAPA) == spans.NAMES
    for name in spans.NAMES:
        assert f"``{name}``" in spans.__doc__, name

    def no_range(name):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    for name in sorted(spans.NAMES):
        with spans.span(name, torch.device("cpu")) as inner:
            assert inner is None
        assert spans.span(name) is spans.OFF
    tracemalloc.start()
    try:
        for _ in range(10_000):
            with spans.span("deeplip.step"):
                pass
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1024   # an object a call would be >= 10,000 x 48 bytes
    assert spans.totals() == {}
    monkeypatch.undo()
    with _cpu_profile() as prof:
        torch.ones(8).sum()
    assert _deeplip_events(prof) == []
    assert spans.totals() == {}


def test_nested_spans_count_host_and_self_time():
    own = []
    with _cpu_profile():
        for _ in range(2):
            with spans.span("deeplip.step"):
                t0 = time.perf_counter()
                time.sleep(0.02)
                own.append(time.perf_counter() - t0)
                with spans.span("deeplip.forward"):
                    time.sleep(0.03)
    got = spans.totals()
    step, forward = got["deeplip.step"], got["deeplip.forward"]
    assert set(got) == {"deeplip.step", "deeplip.forward"}
    assert step["count"] == forward["count"] == 2
    assert forward["host_ms"] >= 60 and forward["self_host_ms"] == forward["host_ms"]
    assert step["host_ms"] >= 100
    assert step["self_host_ms"] == pytest.approx(step["host_ms"] - forward["host_ms"], abs=1e-6)
    assert step["self_host_ms"] == pytest.approx(1e3 * sum(own), abs=2.0)
    assert step["device_ms"] is None and forward["device_ms"] is None
    # the totals build up until reset
    with _cpu_profile():
        with spans.span("deeplip.step"):
            pass
    assert spans.totals()["deeplip.step"]["count"] == 3
    spans.reset()
    assert spans.totals() == {}


def test_a_span_takes_only_the_known_names():
    with _cpu_profile():
        with pytest.raises(ValueError, match="unknown span"):
            spans.span("deeplip.loss")
    assert spans.span("deeplip.loss") is spans.OFF   # off, nothing is checked


def test_phase_ranges_nest_inside_the_step_in_the_trace():
    w = torch.ones(16, requires_grad=True)
    with _cpu_profile() as prof:
        with spans.span("deeplip.step"):
            with spans.span("deeplip.forward"):
                loss = (w * torch.arange(16.0)).square().sum()
            with spans.span("deeplip.backward"):
                loss.backward()
    events = {e.name(): e for e in _deeplip_events(prof)}
    assert set(events) == {"deeplip.step", "deeplip.forward", "deeplip.backward"}
    step = events["deeplip.step"]
    for name in ("deeplip.forward", "deeplip.backward"):
        e = events[name]
        assert step.start_ns() <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= step.start_ns() + step.duration_ns()
    fwd, bwd = events["deeplip.forward"], events["deeplip.backward"]
    assert fwd.start_ns() + fwd.duration_ns() <= bwd.start_ns()


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def query(self):
        return self.recorded

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 1.5


def test_events_time_a_card_span_and_none_while_capturing(monkeypatch):
    card = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    _FakeEvent.made = 0
    with _cpu_profile() as prof:
        with spans.span("deeplip.forward", card):
            pass
    assert _FakeEvent.made == 0
    assert [e.name() for e in _deeplip_events(prof)] == ["deeplip.forward"]
    forward = spans.totals()["deeplip.forward"]
    assert forward["count"] == 1 and forward["device_ms"] is None
    spans.reset()
    # not capturing: one pair per span; completed pairs fold in once
    # FOLD_AT are pending, and totals() resolves the rest
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(spans, "FOLD_AT", 3)
    with _cpu_profile():
        for _ in range(4):
            with spans.span("deeplip.backward", card):
                pass
        assert len(spans.REGISTRY._pending) == 1
    assert _FakeEvent.made == 8
    assert spans.totals()["deeplip.backward"]["device_ms"] == pytest.approx(6.0)
    assert spans.REGISTRY._pending == []
    with _cpu_profile():
        with spans.span("deeplip.backward", torch.device("cpu")):
            pass
    assert _FakeEvent.made == 8


# ---------------------------------------------------------------- trainers
VIDEO_CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3, 5, 7],
             "tcn_num_layers": 2, "tcn_dropout": 0.2, "tcn_dwpw": False, "tcn_width_mult": 1,
             "width_mult": 1.0}
VIDEO_SMALL = dict(crop_size=(24, 24), hidden_dim=8, trunk_layers=(1, 1, 1, 1))
MFCC = {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True, "normalize": True,
        "delta": False, "win_len": 0.025, "win_shift": 0.01}
AUDIO_CFG = {
    "data": {"frames": [40, 40], "python_data_config": {
        "rate": 16000, "feat_type": "mfcc", "mfcc": MFCC}},
    "model": {"arch": "tdnn", "tdnn": {
        "input_dim": 24, "hidden_dim": [16, 16, 24], "context": [[-2, 0, 2], [0], [0]],
        "tdnn_layers": 3, "embedding_dim": 12, "pooling": "statistic",
        "attention_hidden_size": 8, "bn_first": True}},
    "train": {"loss": "LMCL", "scale": 30, "margin": [0.2, 0.2], "type": "sgd", "bs": 4,
              "lr_decay": 0.1, "lr_decay_step": [1000], "epoch": 1,
              "sgd": {"init_lr": 0.01, "weight_decay": 1e-5, "momentum": 0.9}},
    "test": {},
}
SAMPLES = 400 + 39 * 160   # 40 frames


def _video_step(tmp_path):
    g = torch.Generator().manual_seed(3)
    clips = torch.randint(0, 256, (3, 5, 28, 28), dtype=torch.uint8, generator=g)
    trainer = VideoTrainer(VIDEO_CFG, 4, device="cpu", exp_root=str(tmp_path), **VIDEO_SMALL)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)   # the TCN's dropout masks
        out = trainer.train_step(clips, torch.tensor([5, 4, 5]), torch.tensor([0, 3, 1]),
                                 torch.Generator().manual_seed(11))
    return out["loss"]


def _audio_step(tmp_path):
    g = torch.Generator().manual_seed(5)
    pcm = torch.randint(-3000, 3000, (4, SAMPLES), dtype=torch.int16, generator=g)
    trainer = AudioTrainer(Config(AUDIO_CFG), device="cpu", n_spk=6, exp_root=str(tmp_path))
    return trainer.train_step(pcm, torch.tensor([0, 5, 2, 2]), 0.2)["loss"]


ECAPA_CFG = {**AUDIO_CFG, "model": {"arch": "ecapa", "ecapa": {
    "channels": 16, "scale": 4, "se_channels": 8, "attention_channels": 8, "mfa_channels": 24,
    "embedding_dim": 12}}}


def _ecapa_step(tmp_path):
    g = torch.Generator().manual_seed(5)
    pcm = torch.randint(-3000, 3000, (4, SAMPLES), dtype=torch.int16, generator=g)
    trainer = AudioTrainer(Config(ECAPA_CFG), device="cpu", n_spk=6, exp_root=str(tmp_path))
    return trainer.train_step(pcm, torch.tensor([0, 5, 2, 2]), 0.2)["loss"]


def _embed(tmp_path):
    g = torch.Generator().manual_seed(9)
    pcm = torch.randint(-3000, 3000, (3, SAMPLES), dtype=torch.int16, generator=g)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)   # the extractor's initial weights
        extractor = AudioExtractor(Config(AUDIO_CFG), device="cpu")
    return extractor.embed(pcm, torch.full((3,), 40, dtype=torch.int32),
                           torch.tensor([SAMPLES, SAMPLES - 500, SAMPLES - 1000]))


def _fusion_trainer(tmp_path, crop: int = 24):
    return FusionTrainer(AUDIO_CFG["model"], VIDEO_CFG, 4,
                         audio_data_opts=AUDIO_CFG["data"]["python_data_config"], device="cpu",
                         exp_root=str(tmp_path), crop_size=(crop, crop), video_hidden_dim=8,
                         video_trunk_layers=(1, 1, 1, 1))


def _fusion_batch(size: int = 28):
    g = torch.Generator().manual_seed(13)
    pcm = 0.1 * torch.randn((3, SAMPLES), generator=g)
    clips = torch.randint(0, 256, (3, 2, 5, size, size), dtype=torch.uint8, generator=g)
    return (pcm, clips, torch.tensor([[5, 3], [4, 0], [0, 0]]), torch.tensor([2, 1, 0]),
            torch.tensor([0, 3, 1]))


def _fusion_step(tmp_path):
    return _fusion_trainer(tmp_path).train_step(*_fusion_batch())["loss"]


@pytest.mark.parametrize("run,names", [
    (_video_step, STEP), (_audio_step, STEP),
    (_embed, ("deeplip.embed", "deeplip.input", "deeplip.forward")),
    (_fusion_step, FUSION_STEP)],
    ids=["video_train_step", "audio_train_step", "extractor_embed", "fusion_train_step"])
def test_one_span_of_each_phase_and_the_same_numbers(run, names, tmp_path):
    plain = run(tmp_path / "plain")
    assert spans.totals() == {}
    with _cpu_profile() as prof:
        traced = run(tmp_path / "traced")
    assert torch.equal(plain, traced)
    got = spans.totals()
    assert set(got) == set(names)
    assert all(got[n]["count"] == 1 and got[n]["device_ms"] is None for n in names)
    outer = got[names[0]]
    inner = sum(got[n]["host_ms"] for n in names[1:])
    assert inner <= outer["host_ms"]
    assert outer["self_host_ms"] == pytest.approx(outer["host_ms"] - inner, abs=1e-6)
    assert sorted(e.name() for e in _deeplip_events(prof)) == sorted(names)


def test_an_ecapa_step_records_its_blocks_inside_the_forward(tmp_path):
    """One ECAPA-TDNN train step under a CPU profiler: the three blocks'
    Res2Net chains and SE gates and the one pooling inside
    ``deeplip.forward``, none in the backward; with no profiler none."""
    plain = _ecapa_step(tmp_path / "plain")
    assert spans.totals() == {}
    with _cpu_profile() as prof:
        traced = _ecapa_step(tmp_path / "traced")
    assert torch.equal(plain, traced)
    got = spans.totals()
    assert set(got) == set(STEP) | set(ECAPA)
    assert {n: got[n]["count"] for n in ECAPA} == {"deeplip.ecapa.res2net": 3,
                                                   "deeplip.ecapa.se": 3, "deeplip.ecapa.pool": 1}
    assert sum(got[n]["host_ms"] for n in ECAPA) <= got["deeplip.forward"]["host_ms"]
    events = _deeplip_events(prof)
    forward = next(e for e in events if e.name() == "deeplip.forward")
    end = forward.start_ns() + forward.duration_ns()
    for e in events:
        if e.name() in ECAPA:
            assert forward.start_ns() <= e.start_ns() and e.start_ns() + e.duration_ns() <= end


def test_a_fusion_steps_phases_are_siblings_that_sum_to_the_step(tmp_path):
    """Six sibling phases under one ``deeplip.step``: none nests in another,
    and together they hold all but 1 % of the step's host time; ``head_step``
    alone records the step and the head's three phases. The crop is the
    recipe's 88 pixels so that a step's work (≈ 0.3 s on one thread) dwarfs
    what the profiler's ranges cost the step between its phases (≈ 1 ms in
    all)."""
    trainer = _fusion_trainer(tmp_path, crop=88)
    batch = _fusion_batch(96)
    trainer.train_step(*batch)   # first calls allocate and dispatch once
    spans.reset()
    with _cpu_profile() as prof:
        trainer.train_step(*batch)
    got = spans.totals()
    assert set(got) == set(FUSION_STEP)
    step, phases = got["deeplip.step"], FUSION_STEP[1:]
    for name in phases:
        assert got[name]["self_host_ms"] == got[name]["host_ms"], name   # no child spans
    total = sum(got[name]["host_ms"] for name in phases)
    assert total <= step["host_ms"] and total >= 0.99 * step["host_ms"], (total, step)
    events = sorted((e for e in _deeplip_events(prof) if e.name() != "deeplip.step"),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in events] == list(phases)
    for a, b in zip(events, events[1:]):
        assert a.start_ns() + a.duration_ns() <= b.start_ns()
    xv, em = torch.randn(3, 12), torch.randn(3, 512)
    spans.reset()
    with _cpu_profile():
        trainer.head_step(xv, em, batch[3], batch[4])
    assert set(spans.totals()) == {"deeplip.step", "deeplip.forward", "deeplip.backward",
                                   "deeplip.optimizer"}
