"""The audio serving surface of the port: ``SpeakerVerifier`` semantics (the
counterparts of ``tests/test_serve.py``), its scores against the JAX
package's ``SpeakerVerifier`` with the same weights (1e-4, the embedding
bar), ``MicroBatcher`` against direct calls, the ``cli/verify.py``
subcommands, and the two process-wide pieces a second thread touches: the
kernel build-and-load and the FP32 pin."""

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu_torch.cli import verify as cli_verify
from deeplip_tpu_torch.core import device as core_device
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.audio_io import read_wav, write_wav
from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance
from deeplip_tpu_torch.eval.snorm import asnorm_trial_scores, asnorm_trial_scores_np
from deeplip_tpu_torch.interop.from_jax import speaker_embnet_state_dict
from deeplip_tpu_torch.ops.cuda import build
from deeplip_tpu_torch.serve import MicroBatcher, ProfileVerifier, SpeakerVerifier
from deeplip_tpu_torch.serve.verifier import cohort_fingerprint
from tests.test_torch_extract_e2e import DATA, TINY_MODEL, _randomised_state

torch.set_num_threads(1)


def _config():
    return {"data": DATA, "model": TINY_MODEL, "train": {"loss": "LMCL", "type": "sgd", "bs": 8},
            "test": {"batch_size": 4, "n_buckets": 2, "matmul_precision": "highest"}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 speakers x 3 ragged PCM16 wavs, a trial list over all pairs and the
    config as a JSON file."""
    root = str(tmp_path_factory.mktemp("serve"))
    rng = np.random.default_rng(0)
    utts, names = {}, []
    for s in range(3):
        os.makedirs(os.path.join(root, f"s{s}"))
        for u in range(3):
            n = int(rng.integers(12000, 20000))
            t = np.arange(n) / 16000.0
            y = (0.3 * np.sin(2 * np.pi * (120 + 50 * s) * t)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
            name = f"s{s}/u{u}.wav"
            write_wav(os.path.join(root, name), y, 16000)
            utts.setdefault(f"spk{s}", []).append(os.path.join(root, name))
            names.append(name)
    trial_path = os.path.join(root, "trials.txt")
    with open(trial_path, "w") as f:
        for a in range(len(names)):
            for b in range(a + 1, len(names)):
                f.write(f"{int(names[a][:2] == names[b][:2])} {names[a]} {names[b]}\n")
    cfg_path = os.path.join(root, "audio.json")
    with open(cfg_path, "w") as f:
        json.dump(_config(), f)
    return root, utts, trial_path, cfg_path


def _calibrate(v, utts):
    """Running statistics near the corpus' batch statistics (the card
    check's own helper): with the defaults (0, 1) a random network maps every
    utterance to nearly one direction, and no score would tell two apart."""
    paths = [p for ps in utts.values() for p in ps]
    one_batch = v._utt_set([EvalUtterance(p, p) for p in paths],
                           set_overrides={"n_buckets": 1, "batch_size": len(paths)})
    chip_smoke.calibrate_bn(v.extractor, next(iter(one_batch.batches())), seed=1)


@pytest.fixture(scope="module")
def verifier(corpus):
    _, utts, _, cfg_path = corpus
    v = SpeakerVerifier(cfg_path, device="cpu")
    _calibrate(v, utts)
    return v


@pytest.fixture
def enrolled(verifier, corpus):
    """The verifier with one utterance enrolled per speaker; threshold and
    cohort are put back afterwards."""
    _, utts, _, _ = corpus
    saved = verifier.threshold, verifier.cohort, dict(verifier.profiles)
    for s in utts:
        verifier.enroll(s, utts[s][0])
    yield verifier
    verifier.threshold, verifier.cohort = saved[:2]
    verifier.profiles = saved[2]


def test_embed_files_matches_embed_pcm(verifier, corpus):
    _, utts, _, _ = corpus
    path = utts["spk0"][0]
    e_file = verifier.embed_files({"u": path})["u"]
    pcm, sr = read_wav(path)
    e_pcm = verifier.embed_pcm({"u": pcm}, rate=sr)["u"]
    # embed_files ships int16 and rescales on the device: the same float32
    # samples, so agreement is f32 roundoff at most
    np.testing.assert_allclose(e_file.numpy(), e_pcm.numpy(), atol=1e-6, rtol=0)
    assert abs(float(torch.linalg.vector_norm(e_file)) - 1.0) < 1e-5


def test_enroll_score_identify(enrolled, corpus):
    v, (_, utts, _, _) = enrolled, corpus
    speakers = list(utts)
    s0 = speakers[0]
    # a single-utterance profile is that utterance's embedding: score 1.0
    assert v.score(s0, utts[s0][0]) == pytest.approx(1.0, abs=1e-5)
    top = v.identify(utts[s0][0], top_k=len(speakers))
    assert top[0][0] == s0 and top[0][1] == pytest.approx(1.0, abs=1e-5)
    assert len(top) == len(speakers)
    e0 = v.profiles[s0].copy()
    v.enroll(s0, utts[s0][:2])
    assert isinstance(v.profiles[s0], np.ndarray)
    assert not np.array_equal(v.profiles[s0], e0)
    assert abs(float(np.linalg.norm(v.profiles[s0])) - 1.0) < 1e-6
    with pytest.raises(KeyError):
        v.score("nobody", utts[s0][0])


def test_calibrate_sets_threshold_and_verify(enrolled, corpus):
    v, (root, utts, trial_path, _) = enrolled, corpus
    eer, thr = v.calibrate(trial_path, root)
    assert 0.0 <= eer <= 1.0 and v.threshold == thr
    s0 = next(iter(utts))
    r = v.verify(s0, utts[s0][0])
    assert r.threshold == thr and r.speaker == s0
    assert r.accept == (r.score >= thr) and r.accept


def test_verify_without_threshold_raises(enrolled, corpus):
    v, (_, utts, _, _) = enrolled, corpus
    v.threshold = None
    with pytest.raises(ValueError, match="no operating threshold"):
        v.verify("spk0", utts["spk0"][0])


def test_profiles_save_load_roundtrip(enrolled, tmp_path):
    out = str(tmp_path / "profiles")
    enrolled.save_profiles(out)
    v2 = ProfileVerifier(device="cpu")
    v2.load_profiles(out)
    assert set(v2.profiles) == set(enrolled.profiles)
    for s in enrolled.profiles:
        np.testing.assert_allclose(v2.profiles[s], enrolled.profiles[s], atol=1e-7)


def test_cohort_asnorm_scoring(enrolled, corpus):
    v, (root, utts, trial_path, _) = enrolled, corpus
    speakers = list(utts)
    s0 = speakers[0]
    probe = utts[s0][1]
    v.threshold = 0.5
    raw = v.score(s0, probe)
    impostors = [p for s in speakers[1:] for p in utts[s]]
    v.set_cohort_files(impostors, top_k=4)
    assert isinstance(v.cohort, np.ndarray) and v.cohort.shape[0] == len(impostors)
    # another scoring scale: the raw-scale threshold is gone
    assert v.threshold is None
    with pytest.raises(ValueError, match="no operating threshold"):
        v.verify(s0, probe)
    normed = v.score(s0, probe)
    assert normed != raw

    e = np.stack([v.profiles[s0], v._embed_one(probe)])
    pair = np.asarray([[0, 1]])
    assert normed == pytest.approx(
        float(asnorm_trial_scores_np(e, pair, v.cohort, top_k=4)[0]), abs=1e-6)
    assert normed == pytest.approx(
        float(asnorm_trial_scores(e, pair, v.cohort, top_k=4, device="cpu")[0]), abs=5e-5)

    top = v.identify(probe, top_k=len(speakers))
    assert len(top) == len(speakers) and top[0][1] >= top[-1][1]
    assert dict(top)[s0] == pytest.approx(normed, abs=1e-6)

    eer, thr = v.calibrate(trial_path, root)
    assert np.isfinite(thr) and 0.0 <= eer <= 1.0
    r = v.verify(s0, probe)
    assert r.threshold == thr and r.score == pytest.approx(normed, abs=1e-6)
    v.set_cohort(None)
    assert v.threshold is None
    assert v.score(s0, probe) == pytest.approx(raw, abs=1e-6)


def test_pair_scores_host_path_matches_device_path(monkeypatch):
    from deeplip_tpu_torch.serve import verifier as mod

    rng = np.random.default_rng(9)
    emb = rng.standard_normal((6, 32)).astype(np.float32)
    pairs = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
    v, v_dev = ProfileVerifier(device="cpu"), ProfileVerifier(device="cpu")
    assert v.host_score_macs == 8_000_000
    v_dev.host_score_macs = 0
    for cohort in (None, rng.standard_normal((20, 32)).astype(np.float32)):
        if cohort is not None:
            v.set_cohort(cohort, top_k=8)
            v_dev.set_cohort(cohort, top_k=8)
        host, dev = v._pair_scores(emb, pairs), v_dev._pair_scores(emb, pairs)
        assert isinstance(host, np.ndarray) and isinstance(dev, np.ndarray)
        np.testing.assert_allclose(host, dev, rtol=0, atol=2e-6)
        np.testing.assert_allclose(v._pair_scores(torch.from_numpy(emb), pairs), host,
                                   rtol=0, atol=0)
    # routing: a small job takes the numpy twin, one over the cutoff does not
    calls = []
    twin = mod.cosine_scores_np
    monkeypatch.setattr(mod, "cosine_scores_np", lambda *a: (calls.append(1), twin(*a))[1])
    v.set_cohort(None)
    v._pair_scores(emb, pairs)
    assert calls == [1]
    v.host_score_macs = 1
    v._pair_scores(emb, pairs)
    assert calls == [1]
    # with no card, the device path of a verifier left on the default raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_card = ProfileVerifier()
    on_card.host_score_macs = 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        on_card._pair_scores(emb, pairs)


def test_cohort_fingerprint():
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert cohort_fingerprint(None) is None
    fp = cohort_fingerprint(m, 5)
    assert len(fp) == 16 and fp == cohort_fingerprint(m.copy(), 5)
    assert fp != cohort_fingerprint(m, 6) and fp != cohort_fingerprint(m.reshape(4, 3), 5)


def test_speaker_verifier_matches_jax(corpus, tmp_path):
    """The same weights in both packages: embeddings, calibrated threshold
    and verify scores within 1e-4, decisions equal."""
    from deeplip_tpu.serve import SpeakerVerifier as JaxSpeakerVerifier

    root, utts, trial_path, _ = corpus
    jv = JaxSpeakerVerifier(JaxConfig(_config()), exp_root=str(tmp_path / "exp"))
    params, stats = _randomised_state(jv.trainer, seed=3)
    pv = SpeakerVerifier(Config(_config()), device="cpu")
    pv.extractor.load_state_dict(speaker_embnet_state_dict(params, stats))
    # calibrated running statistics, written back into the JAX tree
    _calibrate(pv, utts)
    sd = {k: t.numpy() for k, t in pv.extractor.model.state_dict().items()}
    for name in [f"tdnn_{i}" for i in range(len(TINY_MODEL["tdnn"]["context"]))] + ["bn1", "bn2"]:
        node, key = (stats[name]["bn"], name.replace("_", ".") + ".bn") if "tdnn" in name \
            else (stats[name], name)
        node["mean"], node["var"] = sd[key + ".running_mean"], sd[key + ".running_var"]
    jv.trainer.state = jv.trainer.state.replace(batch_stats={"model": stats})

    want_eer, want_thr = jv.calibrate(trial_path, root)
    got_eer, got_thr = pv.calibrate(trial_path, root)
    assert got_thr == pytest.approx(want_thr, abs=1e-4)
    assert got_eer == pytest.approx(want_eer, abs=1e-6)
    for s, paths in utts.items():
        np.testing.assert_allclose(pv.enroll(s, paths[:2]), jv.enroll(s, paths[:2]),
                                   rtol=0, atol=1e-4)
    margins = []
    for claimed in utts:
        for s, paths in utts.items():
            want, got = jv.verify(claimed, paths[2]), pv.verify(claimed, paths[2])
            assert got.score == pytest.approx(want.score, abs=1e-4)
            margins.append(abs(want.score - want_thr))
            if margins[-1] > 1e-3:
                assert got.accept == want.accept
    assert np.mean(np.asarray(margins) > 1e-3) > 0.7   # the demand was made of most trials
    pcm = read_wav(utts["spk1"][2])[0]
    assert [n for n, _ in pv.identify(pcm, top_k=3)] == [n for n, _ in jv.identify(pcm, top_k=3)]


# ---------------------------------------------------------------- MicroBatcher
def test_microbatcher_matches_direct_calls(enrolled, corpus):
    v, (_, utts, _, _) = enrolled, corpus
    speakers = list(utts)
    v.threshold = 0.5
    s0 = speakers[0]
    probe = utts[s0][1]
    with MicroBatcher(v, max_batch=8, max_wait_ms=0) as mb:
        e_batched = mb.embed(probe)
        assert isinstance(e_batched, np.ndarray)
        # the same function of the same samples, but not the same padded
        # length (the direct call buckets adaptively, the batcher by fixed
        # bucket_frames), so sums run over other lengths: f32 rounding
        # through five layers, 1.4e-6 measured on unit-norm embeddings
        np.testing.assert_allclose(e_batched, v._embed_one(read_wav(probe)[0]),
                                   rtol=0, atol=1e-5)
        assert mb.score(s0, probe) == pytest.approx(v.score(s0, probe), abs=1e-5)
        r_mb, r_direct = mb.verify(s0, probe), v.verify(s0, probe)
        assert r_mb.accept == r_direct.accept and r_mb.threshold == r_direct.threshold
        assert r_mb.score == pytest.approx(r_direct.score, abs=1e-5)
        assert ([n for n, _ in mb.identify(probe, top_k=3)]
                == [n for n, _ in v.identify(probe, top_k=3)])
        v.enroll("mb_ref", utts[s0][:2])
        ref_profile = v.profiles.pop("mb_ref")
        got = mb.enroll("mb_spk", utts[s0][:2])
        np.testing.assert_allclose(got, ref_profile, atol=1e-5, rtol=0)
        assert "mb_spk" in v.profiles
        assert mb.score(s0, utts[s0][0]) == pytest.approx(1.0, abs=1e-5)
        assert mb.submit_verify(s0, probe).result().score == r_mb.score


def test_microbatcher_coalesces_concurrent_requests(enrolled, corpus):
    v, (_, utts, _, _) = enrolled, corpus
    speakers = list(utts)
    v.threshold = 0.5
    # three probes of equal length share one bucket: 3 rows pad to 4
    rng = np.random.default_rng(3)
    probes = [(0.1 * rng.standard_normal(16000)).astype(np.float32) for _ in speakers]
    expect = [v.score(s, p) for s, p in zip(speakers, probes)]
    alone = [v.embed_pcm({"_": p}, set_overrides={"n_buckets": 0})["_"].numpy()
             for p in probes]
    mb = MicroBatcher(v, max_batch=8, max_wait_ms=500)
    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            got = list(pool.map(lambda sp: mb.score(sp[0], sp[1]), zip(speakers, probes)))
            batched = list(pool.map(mb.embed, probes))
        for g, e in zip(got, expect):
            assert g == pytest.approx(e, abs=1e-5)
        # the promise of the batcher: what is computed does not change
        # at the same padded length a row served in a batch of four equals
        # the row served alone to f32 rounding carried through the network,
        # not bit for bit: PyTorch's CPU convolutions and GEMMs pick their
        # blocking by the row count (3.5e-6 measured on these noise probes,
        # 6e-8 with untrained running statistics). 1e-5 is the bar the card
        # check holds the same difference to.
        for b, a in zip(batched, alone):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        assert mb.n_batches == 2 and mb.n_requests == 6
        assert mb.n_slots == 8 and mb.n_pad_slots == 2
        assert mb.mean_batch_slots == 3.0
    finally:
        mb.close()


def test_microbatcher_errors_and_close(enrolled, corpus, monkeypatch):
    v, (_, utts, _, _) = enrolled, corpus
    probe = utts["spk0"][0]
    mb = MicroBatcher(v, max_batch=4, max_wait_ms=0)
    try:
        with pytest.raises(KeyError):
            mb.score("nobody", probe)
        v.threshold = None
        with pytest.raises(ValueError, match="no operating threshold"):
            mb.verify("spk0", probe)
        # an extraction that fails reaches the caller's future too
        with monkeypatch.context() as m:
            m.setattr(v, "embed_pcm", lambda *a, **k: 1 / 0)
            with pytest.raises(ZeroDivisionError):
                mb.embed(probe)
        e = mb.embed(probe)                      # the batcher survives
        assert e.ndim == 1 and np.all(np.isfinite(e))
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.embed(probe)
    mb.close()   # a second close is a no-op


# ---------------------------------------------------------------- the CLI
def _run(capsys, *argv):
    cli_verify.main(list(argv))
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


def test_cli_verify_subcommands(corpus, tmp_path, capsys):
    root, utts, trial_path, cfg_path = corpus
    prof = str(tmp_path / "profiles")
    common = ["-c", cfg_path, "-p", prof, "--device", "cpu"]

    with pytest.raises(SystemExit, match="does not exist"):
        cli_verify.main(["verify", *common, "spk0", utts["spk0"][2]])
    for s in ("spk0", "spk1"):
        out, _ = _run(capsys, "enroll", *common, s, *utts[s][:2])
    assert out == {"enrolled": "spk1", "n_utts": 2, "n_speakers": 2}
    assert os.path.exists(os.path.join(prof, "spk0.npy"))

    out, _ = _run(capsys, "calibrate", *common, "--trials", trial_path, "--root", root)
    thr = out["threshold"]
    with open(os.path.join(prof, "_threshold.json")) as f:
        rec = json.load(f)
    assert rec["threshold"] == thr and rec["cohort_fp"] is None
    assert rec["config"] == os.path.abspath(cfg_path) and rec["checkpoint"] is None

    out, _ = _run(capsys, "verify", *common, "spk0", utts["spk0"][2])
    assert out["threshold"] == thr and out["accept"] == (out["score"] >= thr)
    raw_score = out["score"]
    out, _ = _run(capsys, "verify", *common, "--threshold", "2.0", "spk0", utts["spk0"][2])
    assert out["threshold"] == 2.0 and out["accept"] is False
    out, _ = _run(capsys, "identify", *common, "--top-k", "2", utts["spk1"][2])
    assert [r["speaker"] for r in out["ranking"]] and len(out["ranking"]) == 2

    # a cohort changes the scale: the persisted raw-scale threshold is refused
    out, _ = _run(capsys, "cohort", *common, "--top-k", "3", *utts["spk2"])
    assert out == {"cohort_size": 3, "top_k": 3}
    with pytest.raises(ValueError, match="no operating threshold"):
        cli_verify.main(["verify", *common, "spk0", utts["spk0"][2]])
    assert "different scoring scale" in capsys.readouterr().err
    out, _ = _run(capsys, "calibrate", *common, "--trials", trial_path, "--root", root)
    out2, err = _run(capsys, "verify", *common, "spk0", utts["spk0"][2])
    assert out2["threshold"] == out["threshold"] and out2["score"] != raw_score
    assert "warning" not in err

    # another model identity is warned about
    other = str(tmp_path / "other.json")
    with open(other, "w") as f:
        json.dump(_config(), f)
    _, err = _run(capsys, "verify", "-c", other, "-p", prof, "--device", "cpu", "spk0",
                  utts["spk0"][2])
    assert "different space" in err


# ---------------------------------------------------------------- threads
def test_build_load_builds_once_under_concurrent_first_calls(monkeypatch, tmp_path):
    """Threads that reach a kernel's first launch together start one build
    and get one library."""
    builds, handles = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: (handles.append(path), object())[1])
    start = threading.Barrier(6)

    def first_launch(_):
        start.wait()
        return build.load("some_kernel")

    with ThreadPoolExecutor(max_workers=6) as pool:
        libs = list(pool.map(first_launch, range(6)))
    assert builds == [["some_kernel"]] and len(handles) == 1
    assert all(lib is libs[0] for lib in libs)
    assert build.load("some_kernel") is libs[0] and len(builds) == 1
    build.load("another_kernel")
    assert builds == [["some_kernel"], ["another_kernel"]]


def test_build_names_its_temporary_output_per_call(monkeypatch, tmp_path):
    """Two builds of one library, even from one process, write two files."""
    seen = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    replaced = []
    monkeypatch.setattr(build.os, "replace", lambda a, b: replaced.append((a, b)))
    assert build.build(["fbank_fft_kernel"]) == {"fbank_fft_kernel": "ptxas info"}
    build.build(["fbank_fft_kernel"])
    assert len(seen) == 2 and seen[0] != seen[1]
    assert [a for a, _ in replaced] == seen
    assert all(str(b).endswith("libfbank_fft_kernel.so") for _, b in replaced)


def test_fp32_math_holds_across_threads():
    """A thread that leaves its FP32 block must not hand TF32 back to one
    that is still inside its own."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with core_device.fp32_math():
            a_in.set()
            b_in.wait(5)
        a_out.set()

    def thread_b():
        a_in.wait(5)
        with core_device.fp32_math():
            b_in.set()
            a_out.wait(5)
            seen["inside_b"] = (cudnn.allow_tf32, matmul.allow_tf32)

    try:
        threads = [threading.Thread(target=t) for t in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert seen["inside_b"] == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
