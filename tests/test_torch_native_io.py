"""The port's native IO library (``deeplip_tpu_torch/native``) against the
stdlib readers and the JAX package's native module.

The cases of ``tests/test_native_io.py`` (offsets, batches, int16 batches,
npy/npz batches, header probes, corrupt headers, short buffers, corrupt
archives), held bit for bit to the stdlib reader and to the JAX native
module's results; the pipelines' batches bit-equal under each reader; the
``train.loader`` switch; and concurrent first calls building the library
once. Where no compiler exists the library is not available and the tests
skip, as the JAX file does.
"""

import ctypes
import struct
import threading
import wave

import numpy as np
import pytest
import torch

from deeplip_tpu import native as jax_native
from deeplip_tpu.data.audio_pipeline import AudioTrainPipeline as JaxTrainPipeline
from deeplip_tpu.data.manifest import SpeakerManifest as JaxManifest
from deeplip_tpu.data.video_dataset import VideoClipBatches as JaxClipBatches
from deeplip_tpu.data.video_dataset import load_clips as jax_load_clips
from deeplip_tpu_torch import native
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data import video_dataset
from deeplip_tpu_torch.data.audio_io import read_wav, read_wav_int16, write_wav
from deeplip_tpu_torch.data.audio_pipeline import (AudioTrainPipeline, EvalUtterance,
                                                   EvalUtteranceSet)
from deeplip_tpu_torch.data.manifest import SpeakerManifest, Utterance, write_manifest
from deeplip_tpu_torch.data.video_dataset import VideoClipBatches, scan_clip_dir
from deeplip_tpu_torch.train.audio import AudioTrainer

torch.set_num_threads(1)


@pytest.fixture
def lib():
    """Skips where the library cannot be built (no compiler), as the JAX
    tests skip without theirs."""
    if not native.available():
        pytest.skip("native library unavailable (no C++ compiler or zlib)")
    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    return native


def _riff(payload: bytes, fmt: int, bits: int, channels: int, rate: int,
          extensible: bool = False) -> bytes:
    block = channels * bits // 8
    if extensible:
        # the subformat GUID: the format code, then KSDATAFORMAT_SUBTYPE's tail
        fmt_body = struct.pack("<HHIIHHHHIH", 0xFFFE, channels, rate, rate * block,
                               block, bits, 22, bits, 0, fmt) + (
            b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71")
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, channels, rate, rate * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """PCM16 mono at three lengths, PCM16 stereo at 44.1 kHz, 8-, 24- and
    32-bit PCM, IEEE float32 and an extensible PCM16 file."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([16000, 12345, 48000]):
        p = str(root / f"w{i}.wav")
        write_wav(p, (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
        paths.append(p)
    p = str(root / "stereo.wav")
    write_wav(p, (rng.standard_normal((8000, 2)) * 0.1).astype(np.float32), 44100)
    paths.append(p)
    ints = rng.integers(-2 ** 23, 2 ** 23, 3001)
    payloads = {
        "u8.wav": (rng.integers(0, 256, 3001).astype(np.uint8).tobytes(), 1, 8, 1),
        "s24.wav": (b"".join(int(v).to_bytes(3, "little", signed=True) for v in ints),
                    1, 24, 1),
        "s32.wav": (rng.integers(-2 ** 31, 2 ** 31, 3001).astype("<i4").tobytes(), 1, 32, 1),
        "f32.wav": ((rng.standard_normal(3001) * 0.2).astype("<f4").tobytes(), 3, 32, 1),
    }
    for name, (payload, fmt, bits, ch) in payloads.items():
        p = str(root / name)
        with open(p, "wb") as f:
            f.write(_riff(payload, fmt, bits, ch, 16000))
        paths.append(p)
    p = str(root / "ext16.wav")
    with open(p, "wb") as f:
        f.write(_riff(rng.integers(-9000, 9000, 2000).astype("<i2").tobytes(), 1, 16, 1,
                      16000, extensible=True))
    paths.append(p)
    return paths


def test_native_matches_the_stdlib_and_jax_readers(lib, wavs):
    for p in wavs:
        want, rate = read_wav(p)
        got, got_rate = lib.read_wav(p)
        jgot, _ = jax_native.read_wav(p)
        assert got_rate == rate and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=p)
        np.testing.assert_array_equal(got, jgot, err_msg=p)
        assert lib.wav_info(p) == jax_native.wav_info(p)


@pytest.mark.parametrize("start,stop", [(1000, 5000), (0, None), (15990, 99999),
                                        (7000, 3000), (16000, None)])
def test_native_offset_reads(lib, wavs, start, stop):
    got, _ = lib.read_wav(wavs[0], start=start, stop=stop)
    want, _ = read_wav(wavs[0], start=start, stop=stop)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.read_wav(wavs[0], start=start, stop=stop)[0])


def test_native_batch_reads_float_and_int16(lib, wavs):
    pcm16 = [wavs[0], wavs[1], wavs[2], wavs[3], wavs[-1]]
    starts, caps = [0, 100, 200, 0, 50], [4000, 4000, 4000, 4000, 1500]
    stops = [s + c for s, c in zip(starts, caps)]
    for fn in ("read_wav_batch", "read_wav_batch_i16"):
        got = getattr(lib, fn)(pcm16, starts, stops, caps, n_threads=3)
        want = getattr(jax_native, fn)(pcm16, starts, stops, caps, n_threads=3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    flat, offsets, wrote, rates = lib.read_wav_batch(pcm16, starts, stops, caps, n_threads=3)
    flat16, offsets16, wrote16, _ = lib.read_wav_batch_i16(pcm16, starts, stops, caps)
    assert flat16.dtype == np.int16 and list(offsets16) == list(offsets)
    for i, p in enumerate(pcm16):
        f, rate = read_wav(p, start=starts[i], stop=stops[i])
        i16, _ = read_wav_int16(p, start=starts[i], stop=stops[i])
        assert rates[i] == rate and wrote[i] == wrote16[i] == len(f)
        np.testing.assert_array_equal(flat[offsets[i]:offsets[i] + wrote[i]], f)
        np.testing.assert_array_equal(flat16[offsets[i]:offsets[i] + wrote[i]], i16)


def _npy_cases(root):
    rng = np.random.default_rng(0)
    cases = []
    a = rng.integers(0, 255, (29, 96, 96)).astype(np.uint8)
    np.savez(str(root / "clip.npz"), data=a)
    cases.append((str(root / "clip.npz"), a))
    b = rng.standard_normal((1, 17, 512)).astype(np.float32)
    np.savez_compressed(str(root / "emb.npz"), data=b)
    cases.append((str(root / "emb.npz"), b))
    c = rng.integers(0, 255, (12, 50, 50, 1)).astype(np.uint8)
    np.save(str(root / "raw.npy"), c)
    cases.append((str(root / "raw.npy"), c))
    e = rng.integers(-5, 5, (7,)).astype(np.int64)
    np.savez_compressed(str(root / "lab.npz"), data=e)
    cases.append((str(root / "lab.npz"), e))
    return cases


def test_native_npy_batches_and_shape_probes(lib, tmp_path):
    cases = _npy_cases(tmp_path)
    paths = [p for p, _ in cases]
    outs = lib.read_npy_batch(paths, n_threads=3)
    for (path, ref), got, jgot in zip(cases, outs, jax_native.read_npy_batch(paths)):
        assert got.dtype == ref.dtype == jgot.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jgot)
    probed = lib.probe_npy_shapes(paths, n_threads=2)
    assert probed == jax_native.probe_npy_shapes(paths, n_threads=2)
    assert probed == [(ref.shape, ref.dtype) for _, ref in cases]
    assert lib.read_npy_batch([]) == [] and lib.probe_npy_shapes([]) == []


def test_native_npy_short_buffer_errors(lib, tmp_path):
    arr = np.arange(64, dtype=np.float32)
    paths = [str(tmp_path / "a.npy"), str(tmp_path / "b.npz"), str(tmp_path / "c.npz")]
    np.save(paths[0], arr)
    np.savez(paths[1], data=arr)
    np.savez_compressed(paths[2], data=arr)
    c_lib = lib._load()
    for path in paths:
        shape = np.zeros(8, np.int64)
        ndim = ctypes.c_int(0)
        descr = ctypes.create_string_buffer(8)
        buf = np.zeros(16, np.uint8)
        rc = c_lib.dl_read_npy(path.encode(), b"data",
                               buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                               ctypes.c_long(16),
                               shape.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                               ctypes.byref(ndim), descr)
        assert rc < 0, f"{path}: short-capacity copy returned {rc}"
        rc = c_lib.dl_read_npy(path.encode(), b"data", None, ctypes.c_long(0),
                               shape.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                               ctypes.byref(ndim), descr)
        assert rc == arr.nbytes


def _good_wav_bytes(n=2000, rate=16000):
    pcm = (np.random.default_rng(3).standard_normal(n) * 8000).astype("<i2").tobytes()
    return _riff(pcm, 1, 16, 1, rate)


def _mutations():
    good = _good_wav_bytes()

    def set_field(at, value):
        return good[:at] + struct.pack("<H", value) + good[at + 2:]

    return {
        "not_riff": b"JUNK" + good[4:], "not_wave": good[:8] + b"XXXX" + good[12:],
        "truncated_header": good[:20], "truncated_mid_fmt": good[:30],
        "zero_bits": set_field(12 + 8 + 14, 0), "odd_bits": set_field(12 + 8 + 14, 12),
        "zero_channels": set_field(12 + 8 + 2, 0), "empty": b"",
        "no_data_chunk": good[:12 + 8 + 16],
    }


@pytest.mark.parametrize("name", sorted(_mutations()))
def test_corrupt_wav_headers_raise(lib, tmp_path, name):
    p = str(tmp_path / f"{name}.wav")
    with open(p, "wb") as f:
        f.write(_mutations()[name])
    for mod in (lib, jax_native):
        with pytest.raises(IOError):
            mod.wav_info(p)
        with pytest.raises(IOError):
            mod.read_wav(p)
    if name != "odd_bits":   # the stdlib rounds 12-bit PCM to its 2-byte container
        with pytest.raises((ValueError, EOFError, OSError, wave.Error)):
            read_wav(p)


def test_batch_reports_per_file_errors(lib, tmp_path):
    good, bad = str(tmp_path / "good.wav"), str(tmp_path / "bad.wav")
    with open(good, "wb") as f:
        f.write(_good_wav_bytes())
    with open(bad, "wb") as f:
        f.write(_mutations()["zero_bits"])
    paths = [good, bad, str(tmp_path / "missing.wav")]
    args = (paths, [0, 0, 0], [1000] * 3, [1000] * 3)
    for fn in ("read_wav_batch", "read_wav_batch_i16"):
        flat, _, wrote, rates = getattr(lib, fn)(*args, n_threads=2)
        _, _, jwrote, _ = getattr(jax_native, fn)(*args, n_threads=2)
        assert wrote[0] == 1000 and rates[0] == 16000 and wrote[1] < 0 and wrote[2] < 0
        np.testing.assert_array_equal(wrote, jwrote)
    ref, _ = read_wav(good, stop=1000)
    np.testing.assert_array_equal(lib.read_wav_batch(*args)[0][:1000], ref)


def test_corrupt_npz_archives_raise(lib, tmp_path):
    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    good_p = str(tmp_path / "good.npz")
    np.savez_compressed(good_p, data=arr)
    with open(good_p, "rb") as f:
        good = f.read()
    cases = {
        "truncated_zip": good[:len(good) // 2],
        "no_eocd": good.replace(b"PK\x05\x06", b"PK\x06\x06"),
        "bad_magic": b"XX" + good[2:], "empty": b"",
        "npy_bad_magic": b"\x92NUMPY" + b"\x00" * 64,
        "npy_truncated": b"\x93NUMPY\x01\x00\xff\xff",
    }
    for name, data in cases.items():
        p = str(tmp_path / f"{name}.npz")
        with open(p, "wb") as f:
            f.write(data)
        for mod in (lib, jax_native):
            with pytest.raises(IOError):
                mod.read_npy_batch([p], key="data")
            with pytest.raises(IOError):
                mod.probe_npy_shapes([p], key="data")
    with pytest.raises(IOError):
        lib.read_npy_batch([good_p], key="nope")
    (got,) = lib.read_npy_batch([good_p], key="data")
    np.testing.assert_array_equal(got, arr)


def _corpus(root, n_spk=3, per_spk=3):
    rng = np.random.default_rng(1)
    speakers = []
    for s in range(n_spk):
        utts = []
        for u in range(per_spk):
            p = str(root / f"s{s}_u{u}.wav")
            n = int(rng.integers(8000, 20000))
            write_wav(p, (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
            utts.append(Utterance(p, n / 16000, 16000))
        speakers.append(utts)
    path = str(root / "manifest.csv")
    write_manifest(path, speakers)
    return path


@pytest.mark.parametrize("transport", ["auto", "float32"])
def test_train_batches_equal_under_each_reader(lib, tmp_path, transport):
    manifest = _corpus(tmp_path)
    kw = dict(frame_range=(30, 50), n_buckets=3, num_workers=2, transport=transport)
    runs = [AudioTrainPipeline(SpeakerManifest.load(manifest), 4, reader=r, **kw)
            for r in (read_wav, lib.read_wav)]
    runs.append(JaxTrainPipeline(JaxManifest.load(manifest), 4, reader=jax_native.read_wav,
                                 **kw))
    assert {p._resolve_transport() for p in runs} == {
        "int16" if transport == "auto" else "float32"}
    for epoch in (0, 1):
        batches = [list(p.epoch(epoch)) for p in runs]
        assert len(batches[0]) == runs[0].batches_per_epoch() > 0
        for same in zip(*batches, strict=True):
            for b in same[1:]:
                assert b["pcm"].dtype == same[0]["pcm"].dtype
                np.testing.assert_array_equal(b["pcm"], same[0]["pcm"])
                np.testing.assert_array_equal(b["labels"], same[0]["labels"])


def test_eval_batches_equal_with_and_without_the_header_probe(lib, tmp_path, monkeypatch):
    _corpus(tmp_path, n_spk=2)
    utts = [EvalUtterance(f"s{s}/u{u}", str(tmp_path / f"s{s}_u{u}.wav"))
            for s in range(2) for u in range(3)]

    def batches():
        return list(EvalUtteranceSet(utts, batch_size=4, n_buckets=2, num_workers=2,
                                     transport="auto").batches())

    with_native = batches()
    monkeypatch.setattr(native, "available", lambda: False)
    stdlib = batches()
    assert len(with_native) == len(stdlib) > 0
    for a, b in zip(with_native, stdlib):
        assert a["names"] == b["names"] and a["pcm"].dtype == b["pcm"].dtype == np.int16
        for key in ("pcm", "feat_lengths", "sample_lengths"):
            np.testing.assert_array_equal(a[key], b[key])


def test_train_loader_switch(lib, tmp_path):
    manifest = _corpus(tmp_path)
    cfg = {"data": {"frames": [30, 40], "train_manifest": manifest,
                    "python_data_config": {"rate": 16000, "feat_type": "mfcc"}},
           "model": {"arch": "tdnn", "tdnn": {
               "input_dim": 24, "hidden_dim": [8, 8], "context": [[-1, 0, 1], [0]],
               "tdnn_layers": 2, "embedding_dim": 4, "pooling": "statistic",
               "bn_first": True}},
           "train": {"bs": 4, "frame_buckets": 2, "loader_workers": 2}}
    default = AudioTrainer(Config(cfg), device="cpu")
    cfg["train"]["loader"] = "python"
    stdlib = AudioTrainer(Config(cfg), device="cpu")
    assert default.pipeline.reader is native.read_wav and stdlib.pipeline.reader is read_wav
    for a, b in zip(default.pipeline.epoch(1), stdlib.pipeline.epoch(1), strict=True):
        assert a["pcm"].dtype == np.int16
        np.testing.assert_array_equal(a["pcm"], b["pcm"])


def _clip_corpus(root):
    rng = np.random.default_rng(1)
    for spk in ("s1", "s2"):
        (root / "corpus" / spk).mkdir(parents=True)
        for i in range(3):
            clip = rng.integers(0, 255, (10 + i, 24, 24, 1)).astype(np.uint8)
            np.savez(str(root / "corpus" / spk / f"c{i}.npz"), data=clip)
    return str(root / "corpus")


def test_clip_batches_equal_under_each_reader(lib, tmp_path, monkeypatch):
    corpus = _clip_corpus(tmp_path)
    clips = scan_clip_dir(corpus)
    kw = dict(batch_size=4, shuffle=True, max_frames=11, num_workers=2)
    native_batches = list(VideoClipBatches(clips, **kw).epoch(0))
    jax_batches = list(JaxClipBatches(clips, **kw).epoch(0))
    monkeypatch.setattr(native, "npy_available", lambda: False)
    numpy_batches = list(VideoClipBatches(clips, **kw).epoch(0))
    for nb, pb, jb in zip(native_batches, numpy_batches, jax_batches, strict=True):
        assert nb["names"] == pb["names"] == jb["names"]
        for key in ("clips", "lengths", "labels"):
            np.testing.assert_array_equal(nb[key], pb[key])
            np.testing.assert_array_equal(nb[key], jb[key])


def test_fortran_order_clips_fall_back_to_np_load(lib, tmp_path):
    rng = np.random.default_rng(2)
    clip = np.asfortranarray(rng.integers(0, 255, (6, 8, 8)).astype(np.uint8))
    path = str(tmp_path / "f.npz")
    np.savez(path, data=clip)
    with pytest.warns(UserWarning, match="fell back to np.load"):
        (got,) = video_dataset.load_clips([path])
    with pytest.warns(UserWarning, match="fell back to np.load"):
        (want,) = jax_load_clips([path])
    np.testing.assert_array_equal(got, clip)
    np.testing.assert_array_equal(got, want)


def test_concurrent_first_calls_build_once(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("native library unavailable (no C++ compiler or zlib)")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    calls = []
    real_run = native.subprocess.run

    def counting_run(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counting_run)
    results = []
    threads = [threading.Thread(target=lambda: results.append(native.available()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == [True] * 8 and len(calls) == 1
    built = list((tmp_path / "_build").rglob("*"))
    assert [p.name for p in built if p.is_file()] == ["libdeeplip_native.so"]
    assert "-lz" in calls[0] and str(native.SOURCE) in calls[0]


def test_a_host_that_cannot_compile_keeps_the_stdlib(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    assert native.available() is False and native.npy_available() is False
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.wav_info("x.wav")
    manifest = _corpus(tmp_path)
    trainer = AudioTrainer(Config({
        "data": {"frames": [30, 40], "train_manifest": manifest,
                 "python_data_config": {"rate": 16000, "feat_type": "mfcc"}},
        "model": {"arch": "tdnn", "tdnn": {
            "input_dim": 24, "hidden_dim": [8, 8], "context": [[-1, 0, 1], [0]],
            "tdnn_layers": 2, "embedding_dim": 4, "pooling": "statistic", "bn_first": True}},
        "train": {"bs": 4, "frame_buckets": 2}}), device="cpu")
    assert trainer.pipeline.reader is read_wav
