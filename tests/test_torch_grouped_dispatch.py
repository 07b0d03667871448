"""Grouped train-step dispatch (``steps_per_dispatch: K > 1``) in the port's
audio and video trainers, against the JAX package's.

- Grouping: ``train.audio.group_batches`` forms the JAX ``_group_batches``
  groups and single tails, and the video trainer's flush forms the groups
  of the JAX ``VideoTrainer.train`` flush (the step functions of both
  trainers replaced by recorders).
- f64 against JAX: the port's grouped audio steps against
  ``_train_step_group`` (LMCL, the margin switching between groups) within
  1e-9, and its grouped video steps against the JAX ``_train_step_group``
  at the JAX draws' crop offsets and flips, within the video f64 bar 1e-7.
- A grouped training run equals a single-step run from the same seed, bit
  for bit (on the CPU a group runs its K steps eagerly).
- The runner's bookkeeping on the card, played out on the CPU with a stub
  graph: the K eager warm-up steps leave no trace in the state, a capture
  moves no launch count, each replay adds what the capture recorded, a
  replaced state tensor forces a new capture, and the returned metrics are
  copies; a capture short of memory, and (where cuDNN runs deterministic)
  a first replay not bit-equal to the eager steps, are refused.
- The optimizers' device-tensor rate against the float rate.
"""

import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.data.synthetic import make_audio_corpus, make_video_corpus
from deeplip_tpu.train.audio import _group_batches as jax_group_batches
from deeplip_tpu.train.video import VideoTrainer as JaxVideoTrainer
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.video_dataset import VideoClipBatches, scan_clip_dir
from deeplip_tpu_torch.ops.cuda import build, launch_counts
from deeplip_tpu_torch.train import dispatch
from deeplip_tpu_torch.train.audio import AudioTrainer, group_batches
from deeplip_tpu_torch.train.state import torch_adam, torch_sgd
from deeplip_tpu_torch.train.video import VideoTrainer
from tests import test_torch_audio_train as A
from tests import test_torch_video_train as VT

torch.set_num_threads(1)


# ----------------------------------------------------------------- grouping
def _pcm_source():
    """Batches whose shapes run 3, 2, 1, 4 long, with a Kaldi-feature batch
    in the middle of a run."""
    rng = np.random.default_rng(0)
    out = []
    for n, frames in ((3, 10), (2, 12), (1, 10), (4, 12)):
        for _ in range(n):
            out.append({"pcm": rng.integers(-9, 9, (2, frames)).astype(np.int16),
                        "labels": rng.integers(0, 5, 2), "n_frames": frames})
    out.insert(4, {"feats": np.zeros((2, 3, 4), np.float32), "labels": np.zeros(2, int),
                   "n_frames": 3})
    return out


def _describe(batches):
    return [(b.get("group"), tuple(b.get("pcm", b.get("feats")).shape), b["n_frames"],
             b.get("pcm", b.get("feats")).tobytes(), np.asarray(b["labels"]).tobytes())
            for b in batches]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_group_batches_equal_jax(k):
    got = _describe(group_batches(iter(_pcm_source()), k))
    assert got == _describe(jax_group_batches(iter(_pcm_source()), k))
    groups = [g for g, *_ in got if g]
    assert (groups and set(groups) == {k}) if k > 1 else not groups


class _Batches:
    """A ``VideoClipBatches`` stand-in: 8-row uint8 batches of the given
    clip lengths (8 rows, so the JAX trainer's mesh adds no pad rows)."""

    def __init__(self, lengths):
        self.lengths = lengths

    def epoch(self, epoch):
        for i, t in enumerate(self.lengths):
            yield {"clips": np.full((8, t, VT.HW, VT.HW), i, np.uint8),
                   "lengths": np.full(8, t, np.int32), "labels": np.zeros(8, np.int64)}


def _jax_dispatches(k, batches, tmp_path):
    jtr = JaxVideoTrainer(JaxConfig(VT.CFG), VT.NC, exp_root=str(tmp_path / "jax"),
                          steps_per_dispatch=k, **VT.SMALL)
    calls = []
    done = {"loss": 0.0, "acc": 0.0}

    def group(state, clips, lengths, labels, keys):
        calls.append(("group", [int(c[0, 0, 0, 0]) for c in clips]))
        return state, {n: np.zeros(len(clips)) for n in done}

    def single(state, clips, lengths, labels, key):
        calls.append(("step", [int(clips[0, 0, 0, 0])]))
        return state, done

    jtr.ensure_state = lambda: types.SimpleNamespace(step=0)
    jtr._train_step_group, jtr._train_step, jtr.save = group, single, lambda epoch: None
    jtr.train(batches, epochs=1)
    return calls


def _port_dispatches(k, batches, tmp_path):
    ptr = VideoTrainer(VT.CFG, VT.NC, device="cpu", exp_root=str(tmp_path / "port"),
                       steps_per_dispatch=k, **VT.SMALL)
    calls = []

    def group(clips, lengths, labels, draws):
        calls.append(("group", [int(c[0, 0, 0, 0]) for c in clips]))
        ptr.step += len(clips)
        return {"loss": torch.zeros(len(clips)), "acc": torch.zeros(len(clips))}

    def single(clips, lengths, labels, generator):
        calls.append(("step", [int(clips[0, 0, 0, 0])]))
        ptr.step += 1
        return {"loss": torch.zeros(()), "acc": torch.zeros(())}

    ptr.train_group, ptr.train_step, ptr.save = group, single, lambda epoch: None
    ptr.train(batches, epochs=1)
    return calls


@pytest.mark.parametrize("k", [2, 3])
def test_video_flush_forms_the_jax_groups(k, tmp_path):
    batches = _Batches([5, 5, 5, 7, 7, 5, 5, 5, 5, 5, 9])
    want = _jax_dispatches(k, batches, tmp_path)
    assert want == _port_dispatches(k, batches, tmp_path)
    assert any(kind == "group" for kind, _ in want) and any(kind == "step" for kind, _ in want)


# ----------------------------------------------------------- f64 against JAX
def test_grouped_audio_steps_match_jax_f64(tmp_path):
    """Two groups of two LMCL steps from f64 PCM (the plain front-end on
    both sides), the margin switching between the groups."""
    from deeplip_tpu_torch.ops.framing import samples_for_frames

    k, tol = 2, 1e-9
    rng = np.random.default_rng(3)
    s = samples_for_frames(A.T, 0.025, 0.01, 16000)
    pcm = rng.uniform(-0.2, 0.2, (2, k, A.BS, s))
    labels = rng.integers(0, A.N_SPK, (2, k, A.BS)).astype(np.int64)
    with jax.enable_x64(True):
        jtr, state, ptr = A._pair(A._cfg("LMCL", steps_per_dispatch=k), "float64", tmp_path)
        assert ptr.steps_per_dispatch == k
        for g, margin in enumerate((0.2, 0.3)):
            state, jm = jtr._train_step_group(state, jnp.asarray(pcm[g]), jnp.asarray(labels[g]),
                                              jnp.float64(margin))
            pm = ptr.train_group(torch.tensor(pcm[g]), torch.tensor(labels[g]), margin)
            np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]), rtol=tol,
                                       atol=tol, err_msg=f"group {g}")
            np.testing.assert_allclose(pm["acc"].numpy(), np.asarray(jm["acc"]))
        assert ptr.step == 2 * k
        A._compare_states(state, ptr, tol, 2 * k)


def _jax_draws(key, b, h, w, size):
    """The crop offsets and flips the JAX train step draws from ``key``
    (``_step_math`` → ``train_transform`` → ``random_crop`` / ``horizontal_flip``)."""
    kt, _ = jax.random.split(key)
    kc, kf = jax.random.split(kt)
    kh, kw = jax.random.split(kc)
    return (np.asarray(jax.random.randint(kh, (b,), 0, h - size[0] + 1)),
            np.asarray(jax.random.randint(kw, (b,), 0, w - size[1] + 1)),
            np.asarray(jax.random.bernoulli(kf, 0.5, (b,))))


def test_grouped_video_steps_match_jax_f64(tmp_path, monkeypatch):
    """Two groups of two steps from uint8 clips, the port at the crop offsets
    and flips the JAX trainer draws from its keys. Jitted, XLA rounds the
    f32 pixel affine apart from the two-op form both packages write, and
    Adam amplifies an ulp; so the jitted JAX step reads the affine as the
    256-entry table of its own op-by-op values."""
    from deeplip_tpu.ops import video as JV

    table = jnp.asarray(np.asarray(JV.normalize_pixels(jnp.arange(256, dtype=jnp.uint8))))
    monkeypatch.setattr(JV, "normalize_pixels", lambda clips, *a, **kw: table[clips])
    k, tol, h = 2, 1e-7, VT.HW + 6
    rng = np.random.default_rng(4)
    clips = rng.integers(0, 256, (2, k, VT.BS, VT.T, h, h), np.uint8)
    labels = rng.integers(0, VT.NC, (2, k, VT.BS)).astype(np.int64)
    lengths = np.tile(np.array([VT.T, 0, VT.T - 2], np.int32), (k, 1))
    with jax.enable_x64(True):
        jtr, state, ptr = VT._pair("float64", tmp_path)
        ptr.steps_per_dispatch = k
        for g in range(2):
            keys = jax.random.split(jax.random.PRNGKey(10 + g), k)
            state, jm = jtr._train_step_group(state, jnp.asarray(clips[g]), jnp.asarray(lengths),
                                              jnp.asarray(labels[g]), keys)
            draws = [_jax_draws(key, VT.BS, h, h, ptr.crop_size) for key in keys]
            pm = ptr.train_group(torch.tensor(clips[g]), torch.tensor(lengths),
                                 torch.tensor(labels[g]),
                                 {n: torch.tensor(np.stack(d))
                                  for n, d in zip(("dh", "dw", "flip"), zip(*draws))})
            np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]), rtol=tol,
                                       atol=tol, err_msg=f"group {g}")
        assert ptr.step == 2 * k
        VT._compare_states(state, ptr, tol, 2 * k)


# ---------------------------------------------------- grouped run == single run
def test_grouped_audio_run_equals_a_single_run(tmp_path):
    root = str(tmp_path / "corpus")
    make_audio_corpus(root, n_spk=3, utts_per_spk=4, duration=1.0)
    losses, models = [], []
    for k in (1, 2):
        cfg = A._cfg("LMCL", steps_per_dispatch=k, bs=4, epoch=2, frame_buckets=1,
                     loader_workers=1, log_every=1, lr_decay_step=[1])
        # one crop length, so the sampler's runs of K draw what single
        # steps draw
        cfg["data"].update(frames=[40, 40], train_manifest=os.path.join(root, "manifest.csv"))
        tr = AudioTrainer(Config(cfg), device="cpu", exp_root=str(tmp_path / f"exp{k}"),
                          log_time="run")
        assert tr.pipeline.sampler.bucket_run == k
        losses.append(tr.train())
        models.append(tr.model.state_dict())
    bpe = tr.pipeline.batches_per_epoch()
    assert bpe % 2 == 1   # each epoch ends in a single-step tail
    assert len(losses[0]) == 2 * bpe and losses[0] == losses[1]
    for name, v in models[0].items():
        assert torch.equal(v, models[1][name]), name


def test_grouped_video_run_equals_a_single_run(tmp_path):
    root = str(tmp_path / "clips")
    make_video_corpus(root, n_spk=3, clips_per_spk=4, t=6, size=VT.HW + 4)
    clips = scan_clip_dir(root)
    losses, models = [], []
    for k in (1, 2):
        tr = VideoTrainer(VT.CFG, VT.NC, device="cpu", exp_root=str(tmp_path / f"e{k}"),
                          steps_per_dispatch=k, **VT.SMALL)
        batches = VideoClipBatches(clips, batch_size=4, bucket_t=4, num_workers=1, seed=1)
        losses.append(tr.train(batches, epochs=2, seed=5))
        models.append(tr.model.state_dict())
    assert len(losses[0]) == 6 and losses[0] == losses[1]
    for name, v in models[0].items():
        assert torch.equal(v, models[1][name]), name


# --------------------------------------------------- the runner's bookkeeping
def _stub_entry(key: str) -> tuple:
    """An entry as ``build.entries`` gives it, counted under ``key``, whose
    C function launches nothing and returns 0."""
    def stub(*args):
        return 0
    return stub, (key,)


K1, K3 = _stub_entry("fft"), _stub_entry("bn_prelu_fwd")


def _moved(since: dict) -> tuple[int, int]:
    """K1's and K3's launches since the reading ``since``."""
    now = launch_counts()
    return now["fft"] - since["fft"], now["bn_prelu_fwd"] - since["bn_prelu_fwd"]


class _StubGraph:
    """Stands in for a CUDA graph: replaying it runs the captured steps
    without calling the kernels' wrappers, so no launch count moves."""

    def __init__(self, fn, outputs, replays):
        self.fn, self.outputs, self.replays = fn, outputs, replays

    def replay(self):
        counts = launch_counts()
        for name, value in self.fn().items():   # into the captured outputs
            self.outputs[name].copy_(value)
        now = launch_counts()
        build.add_launches({k: counts[k] - now[k] for k in counts})
        self.replays.append(1)


class _StubRunner(dispatch.GroupedSteps):
    """The card's code path, with a stub in place of the CUDA capture. A
    capture records and runs nothing: the state is put back after it."""

    def __init__(self, *args, replays, **kwargs):
        super().__init__(*args, **kwargs)
        self.captures = True
        self._replays = replays

    def _graph_capture(self, fn):
        saved = [t.clone() for t in self.state()]
        outputs = fn()
        for t, s in zip(self.state(), saved):
            t.copy_(s)
        return _StubGraph(fn, outputs, self._replays), outputs


def test_replay_counts_and_state_with_a_stub_graph():
    start = launch_counts()
    state = {"w": torch.zeros(3)}

    def body(i, inputs, scalars):
        build.launch(K1)          # as a kernel's wrapper launches
        for _ in range(27):
            build.launch(K3)
        state["w"] += inputs["x"][i] * scalars["rate"][i]
        return {"loss": state["w"].sum().clone()}

    replays = []
    runner = _StubRunner(body, lambda: [state["w"]], torch.device("cpu"), replays=replays)
    x = torch.ones(2, 3)
    rate = torch.tensor([1.0, 2.0], dtype=torch.float64)
    out = runner.run({"x": x}, {"rate": rate})
    # the group's 2 steps ran eagerly (their state undone); one replay of 2
    assert runner.warmup_steps == 2 and len(replays) == 1
    assert _moved(start) == (2 + 2, 27 * 4)
    assert torch.equal(state["w"], torch.full((3,), 3.0))
    assert out["loss"].tolist() == [3.0, 9.0]
    out["loss"].zero_()                   # a copy: the static outputs stay
    out = runner.run({"x": x}, {"rate": torch.tensor([0.5, 0.5], dtype=torch.float64)})
    assert out["loss"].tolist() == [10.5, 12.0] and len(replays) == 2
    assert _moved(start) == (6, 27 * 6) and runner.warmup_steps == 2
    assert len(runner.graphs) == 1
    # another shape captures anew; a replaced state tensor does too
    runner.run({"x": torch.ones(3, 3)}, {"rate": torch.ones(3, dtype=torch.float64)})
    assert len(runner.graphs) == 2 and runner.warmup_steps == 5
    state["w"] = state["w"].clone()
    runner.run({"x": x}, {"rate": rate})
    assert runner.warmup_steps == 7 and len(runner.graphs) == 2
    assert _moved(start) == (6 + 3 + 3 + 2 + 2, 27 * 16)


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "default"])
def test_a_first_replay_unlike_the_eager_steps_is_refused(deterministic):
    """A graph that computes other numbers than the eager steps (as one
    whose convolution took another cuDNN algorithm), played out with a stub
    graph whose replay drifts by 1e-6: where cuDNN runs deterministic, its
    first replay is held bit for bit to the group's K eager steps from the
    same state, and the runner raises, keeps no graph and leaves the state
    as it was before the group; a graph that agrees is kept. With cuDNN's
    nondeterministic algorithms allowed the check is off."""
    state = {"w": torch.zeros(3)}
    drift = {"by": 0.0}

    def body(i, inputs, scalars):
        state["w"] += inputs["x"][i] * scalars["rate"][i] + drift["by"]
        return {"loss": state["w"].sum().clone()}

    class Drifting(_StubGraph):
        def replay(self):
            drift["by"] = 1e-6
            try:
                super().replay()
            finally:
                drift["by"] = 0.0

    class DriftingRunner(_StubRunner):
        def _graph_capture(self, fn):
            graph, outputs = super()._graph_capture(fn)
            return Drifting(graph.fn, outputs, graph.replays), outputs

    inputs = {"x": torch.ones(2, 3)}
    scalars = {"rate": torch.tensor([1.0, 2.0], dtype=torch.float64)}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=deterministic, allow_tf32=False):
        drifting = DriftingRunner(body, lambda: [state["w"]], torch.device("cpu"), replays=[])
        if deterministic:
            with pytest.raises(RuntimeError, match="first replay of a group of 2 steps is not "
                                                   "bit-equal .*largest difference"):
                drifting.run(inputs, scalars)
            assert not drifting.graphs and torch.equal(state["w"], torch.zeros(3))
        else:
            drifting.run(inputs, scalars)
            assert len(drifting.graphs) == 1
            state["w"].zero_()
        agreeing = _StubRunner(body, lambda: [state["w"]], torch.device("cpu"), replays=[])
        out = agreeing.run(inputs, scalars)
    assert len(agreeing.graphs) == 1 and out["loss"].tolist() == [3.0, 9.0]
    nan = float("nan")
    assert dispatch._first_unlike({"a": torch.tensor([nan, 1.0])},
                                  {"a": torch.tensor([nan, 1.0])}) is None
    assert "a: largest difference 5.000e-01" == dispatch._first_unlike(
        {"a": torch.tensor([nan, 1.0])}, {"a": torch.tensor([nan, 1.5])})


def test_a_failed_capture_ends_the_generators_capture(monkeypatch):
    """torch clears the card's generator's capture mark only when a capture
    ends cleanly; after a capture that raises, the runner ends one more
    capture, of a single op, so eager dropout works again, and re-raises.
    The CUDA capture is a recording stand-in here."""
    events = []

    @contextlib.contextmanager
    def graph(g, **kwargs):
        events.append("begin")
        yield
        events.append("end")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", graph)
    runner = dispatch.GroupedSteps(lambda i, inputs, scalars: {}, lambda: [],
                                   torch.device("cpu"))

    def host_read():
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        runner._graph_capture(host_read)
    assert events == ["begin", "begin", "end"]
    events.clear()
    assert runner._graph_capture(lambda: {"loss": torch.ones(())})[1]["loss"] == 1
    assert events == ["begin", "end"]


def test_a_runner_whose_graphs_were_dropped_captures_into_a_fresh_pool(monkeypatch):
    """The caching allocator refuses a capture into a pool that no graph
    uses any more while its blocks live on: once a runner's graphs are
    all gone, its next capture takes a fresh pool; while one lives, the
    captures share its pool. The CUDA capture is a recording stand-in."""
    handles, pools = iter(range(10)), []

    @contextlib.contextmanager
    def graph(g, pool=None, **kwargs):
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(handles))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", graph)
    runner = dispatch.GroupedSteps(lambda i, inputs, scalars: {}, lambda: [],
                                   torch.device("cpu"))
    runner.captures = True
    runner._graph_capture(lambda: {})       # no graph yet: a fresh pool
    runner.graphs["a"] = object()
    runner._graph_capture(lambda: {})       # shares the live graph's pool
    runner.graphs.clear()
    runner._graph_capture(lambda: {})       # all dropped: a fresh pool
    assert pools == [0, 0, 1]


def test_the_trainers_hand_the_runner_their_whole_state():
    tr = AudioTrainer(Config(A._cfg("LMCL", steps_per_dispatch=2)), device="cpu",
                      n_spk=A.N_SPK)
    tr.optimizer.init_state()
    ids = {id(t) for t in tr.grouped.state()}
    for t in [*tr.model.parameters(), *tr.model.buffers(), *tr.criterion.parameters()]:
        assert id(t) in ids
    assert all(id(s["momentum_buffer"]) in ids for s in tr.optimizer.state.values())
    vt = VideoTrainer(VT.CFG, VT.NC, device="cpu", steps_per_dispatch=2, **VT.SMALL)
    vt.optimizer.init_state()
    ids = {id(t) for t in vt.grouped.state()}
    assert all(id(t) in ids for t in [*vt.model.parameters(), *vt.model.buffers()])
    assert all(id(t) in ids for s in vt.optimizer.state.values() for t in s.values())


# ----------------------------------------------------------- the rate tensor
@pytest.mark.parametrize("make", [lambda p: torch_sgd(p, 0.1, 0.9, 1e-3),
                                  lambda p: torch_adam(p, 0.1, 1e-3)], ids=["sgd", "adam"])
def test_a_device_tensor_rate_steps_like_the_float_rate(make):
    rng = np.random.default_rng(1)
    p0 = [rng.standard_normal((4, 3)), rng.standard_normal(5)]
    a = [torch.nn.Parameter(torch.tensor(v)) for v in p0]
    b = [torch.nn.Parameter(torch.tensor(v)) for v in p0]
    oa, ob = make(a), make(b)
    for step in range(4):
        grads = [rng.standard_normal(v.shape) for v in p0]
        for ps in (a, b):
            for p, g in zip(ps, grads):
                p.grad = torch.tensor(g)
        lr = 0.1 * 0.5 ** step
        for group in oa.param_groups:
            group["lr"] = lr
        oa.step()
        ob.step(torch.tensor(lr, dtype=torch.float64))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-14,
                                   atol=1e-15)


@pytest.mark.parametrize("kind", ["audio", "video"])
def test_a_dropped_trainer_is_freed_without_the_cycle_collector(kind):
    """A trainer owns its runner, and the runner holds the trainer's step
    body and state through weak references: a dropped trainer is freed at
    once (on the card, with its graphs and their memory pool) while the
    cycle collector is off, and its runner raises instead of stepping it."""
    import gc
    import weakref

    from deeplip_tpu_torch.ops.framing import samples_for_frames

    if kind == "audio":
        tr = AudioTrainer(Config(A._cfg("LMCL", steps_per_dispatch=2)), device="cpu",
                          n_spk=A.N_SPK)
        rng = np.random.default_rng(0)
        pcm = rng.integers(-3000, 3000, (2, A.BS, samples_for_frames(A.T, 0.025, 0.01, 16000)))
        labels = rng.integers(0, A.N_SPK, (2, A.BS))
        tr.train_group(torch.tensor(pcm, dtype=torch.int16), torch.tensor(labels), 0.2)
    else:
        tr = VideoTrainer(VT.CFG, VT.NC, device="cpu", steps_per_dispatch=2, **VT.SMALL)
    runner, ref = tr.grouped, weakref.ref(tr)
    gc.collect()
    gc.disable()
    try:
        del tr
        assert ref() is None
    finally:
        gc.enable()
    with pytest.raises(ReferenceError):
        runner.state()


def test_a_capture_short_of_memory_is_refused(monkeypatch):
    """The card's guard against a warm-up or capture short of memory, where
    cuDNN would quietly take another algorithm than the eager steps, played
    out with stubs: an allocation that failed in either (``num_ooms``
    moved), or the card running out of memory there, makes the runner raise
    and keep no graph, with the launch counts as they were; with none the
    graph is kept."""
    start = launch_counts()
    runner = dispatch.GroupedSteps(lambda i, inputs, scalars: {}, lambda: [],
                                   torch.device("cpu"))
    runner.captures = True
    stats, failed = {"num_ooms": 0}, {"warm_up": 0, "capture": 0, "raise": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: dict(stats))

    def warm_up(k, inputs, scalars):
        stats["num_ooms"] += failed["warm_up"] + failed["raise"]
        if failed["raise"]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"loss": torch.zeros(k)}, []

    def capture(fn):
        build.launch(K1)
        build.launch(K1)
        stats["num_ooms"] += failed["capture"]
        return types.SimpleNamespace(replay=lambda: None), {"loss": torch.zeros(2)}

    monkeypatch.setattr(runner, "_warm_up", warm_up)
    monkeypatch.setattr(runner, "_graph_capture", capture)
    inputs, scalars = {"x": torch.zeros(2, 3)}, {"rate": torch.zeros(2)}
    for where in ("warm_up", "capture", "raise"):
        failed[where] = 1
        with pytest.raises(RuntimeError, match="1 allocation.*failed while warming up and "
                                               "capturing a group of 2"):
            runner._capture(2, inputs, scalars)
        failed[where] = 0
    assert launch_counts() == start
    entry = runner._capture(2, inputs, scalars)
    assert entry.graph is not None and entry.launches == {"fft": 2}
    assert launch_counts() == start
