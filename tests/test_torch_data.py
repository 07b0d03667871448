"""The port's host-side modules against the JAX package's: config loading,
WAV IO and resampling, prefetching, bucket edges and the embedding store."""

import json
import struct
import wave

import numpy as np
import pytest
import torch

from deeplip_tpu.core import config as JC
from deeplip_tpu.data import audio_io as JIO
from deeplip_tpu.data.audio_pipeline import optimal_bucket_edges as jax_bucket_edges
from deeplip_tpu.eval import scoring as JS
from deeplip_tpu_torch.core import config as TC
from deeplip_tpu_torch.data import audio_io as TIO
from deeplip_tpu_torch.data.audio_pipeline import optimal_bucket_edges
from deeplip_tpu_torch.data.prefetch import ThreadedPrefetcher
from deeplip_tpu_torch.eval import scoring as TS

torch.set_num_threads(1)

NESTED = {"data": {"feat_type": "mfcc", "mfcc": {"n_fft": 512, "num_bin": 26},
                   "rate": 16000},
          "model": {"arch": "etdnn", "etdnn": {"context": [[0], [-2, 0, 2]]}},
          "train": None}


def test_config_matches_jax(tmp_path):
    j, t = JC.Config(NESTED), TC.Config(NESTED)
    assert t.data.mfcc.n_fft == 512 and t.model.etdnn.context[1] == [-2, 0, 2]
    assert t.to_dict() == j.to_dict()
    assert t.data.flatten() == j.data.flatten()
    over = {"data": {"mfcc": {"num_bin": 40}}, "test": {"batch_size": 8}}
    assert t.merged(over).to_dict() == j.merged(over).to_dict()
    with pytest.raises(AttributeError):
        t.nothing_here


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_load_audio_config_matches_jax(tmp_path, suffix):
    path = tmp_path / f"audio{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(NESTED))
    else:
        import yaml

        path.write_text(yaml.safe_dump(NESTED))
    want = JC.load_audio_config(str(path))
    got = TC.load_audio_config(str(path))
    assert got.to_dict() == want.to_dict()
    assert got.train == {} and got.test == {}


def _write_float_wav(path, data, rate):
    """IEEE-float32 mono WAV, which the stdlib wave module refuses."""
    raw = np.asarray(data, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, rate, rate * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(raw)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(raw)) + raw)


def test_wav_io_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    pcm16, f32 = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    TIO.write_wav(pcm16, y, 16000)
    _write_float_wav(f32, y, 8000)
    for path in (pcm16, f32):
        for kw in ({}, {"start": 100, "stop": 2500}):
            got, want = TIO.read_wav(path, **kw), JIO.read_wav(path, **kw)
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])
        assert TIO.wav_format(path) == JIO.wav_format(path)
    got, want = TIO.read_wav_int16(pcm16, stop=3000), JIO.read_wav_int16(pcm16, stop=3000)
    assert got[0].dtype == np.int16 and got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(wave.Error):  # not integer PCM
        TIO.read_wav_int16(f32)
    assert TIO.wav_format(str(tmp_path / "missing.wav")) is None


@pytest.mark.parametrize("rates", [(8000, 16000), (44100, 16000), (16000, 16000)])
def test_resample_bit_equal(rates):
    rng = np.random.default_rng(1)
    y = (rng.standard_normal(1471) * 0.1).astype(np.float32)
    got, want = TIO.resample(y, *rates), JIO.resample(y, *rates)
    assert len(got) == TIO.resampled_length(len(y), *rates) == len(want)
    np.testing.assert_array_equal(got, want)


def test_prefetcher_keeps_order_and_raises():
    out = list(ThreadedPrefetcher(range(50), lambda i: i * i, num_workers=4, lookahead=3))
    assert out == [i * i for i in range(50)]
    assert list(ThreadedPrefetcher([(1, 2), (3, 4)], lambda a, b: a + b)) == [3, 7]

    def boom(i):
        if i == 7:
            raise KeyError(i)
        return i

    with pytest.raises(KeyError):
        list(ThreadedPrefetcher(range(20), boom, num_workers=3))


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 3), (2, 8), (3, 50)])
def test_bucket_edges_match_jax(seed, k):
    lengths = np.random.default_rng(seed).integers(20, 300, 200).tolist()
    assert optimal_bucket_edges(lengths, k) == jax_bucket_edges(lengths, k)


def test_embedding_store_npy_tree_and_scores(tmp_path):
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((5, 16)).astype(np.float32)
    names = [f"s{i % 2}/u{i}.wav" for i in range(5)]
    store = TS.EmbeddingStore()
    for n, e in zip(names, emb):
        store[n] = torch.from_numpy(e)
    store.save_npy_tree(str(tmp_path))
    # the on-disk layout is the JAX package's (and the reference's)
    back = JS.EmbeddingStore.load_npy_tree(str(tmp_path), names)
    again = TS.EmbeddingStore.load_npy_tree(str(tmp_path), names)
    for n, e in zip(names, emb):
        np.testing.assert_array_equal(back[n], e)
        np.testing.assert_array_equal(again[n].numpy(), e)
    pairs = np.array([[0, 1], [2, 3], [4, 0]])
    want = JS.cosine_scores_np(emb, pairs)
    np.testing.assert_array_equal(TS.cosine_scores_np(emb, pairs), want)
    got = TS.cosine_scores(torch.from_numpy(emb), torch.from_numpy(pairs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
