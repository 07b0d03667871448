"""The port's audio training data path against the JAX package's.

A synthetic PCM16 corpus (the JAX package's ``make_audio_corpus``) feeds
both sides. The manifest round-trips; the speaker-balanced sampler gives
the same speaker ids and crop lengths for three epochs (``bucket_run`` 1
and 4); ``AudioTrainPipeline`` gives batches bit-equal to the JAX
pipeline's under the float32, int16 and auto transports.
"""

import os

import numpy as np
import pytest
import torch

from deeplip_tpu.data import audio_pipeline as JP
from deeplip_tpu.data.audio_io import read_wav as jax_read_wav
from deeplip_tpu.data.manifest import SpeakerManifest as JaxManifest
from deeplip_tpu.data.sampler import SpeakerBatchSampler as JaxSampler
from deeplip_tpu.data.synthetic import make_audio_corpus
from deeplip_tpu_torch.data import audio_pipeline as PP
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.manifest import SpeakerManifest, Utterance, write_manifest
from deeplip_tpu_torch.data.sampler import SpeakerBatchSampler, frame_buckets

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("audio_train"))
    path, _ = make_audio_corpus(root, n_spk=4, utts_per_spk=3, duration=1.0)
    return path


def test_manifest_round_trip(corpus, tmp_path):
    port = SpeakerManifest.load(corpus)
    ref = JaxManifest.load(corpus)
    assert port.n_spk == ref.n_spk == 4 and port.n_utts == ref.n_utts == 12
    assert port.total_duration == ref.total_duration
    assert port.epoch_length(300, 0.025, 0.01) == ref.epoch_length(300, 0.025, 0.01)
    assert [(s, u.path, u.duration, u.rate) for s, u in port.all_utterances()] == \
        [(s, u.path, u.duration, u.rate) for s, u in ref.all_utterances()]
    out = str(tmp_path / "again.csv")
    write_manifest(out, port.speakers)
    with open(out) as a, open(corpus) as b:
        assert a.read() == b.read()
    again = SpeakerManifest.load(out)
    assert again.speakers == port.speakers
    assert isinstance(again.speakers[0][0], Utterance)


@pytest.mark.parametrize("bucket_run", [1, 4])
def test_sampler_draws_equal_jax(bucket_run):
    kw = dict(frame_range=(200, 400), n_buckets=11, seed=3, bucket_run=bucket_run)
    port = SpeakerBatchSampler(40, 1000, 32, **kw)
    ref = JaxSampler(40, 1000, 32, **kw)
    assert list(port.buckets) == list(ref.buckets) == list(frame_buckets(200, 400, 11))
    assert port.batches_per_epoch() == ref.batches_per_epoch() == 31
    for epoch in (1, 2, 3):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 31
        for (ids_p, n_p), (ids_r, n_r) in zip(got, want):
            np.testing.assert_array_equal(ids_p, ids_r)
            assert n_p == n_r
        if bucket_run == 4:
            lengths = [n for _, n in got]
            assert all(lengths[i] == lengths[i - i % 4] for i in range(len(lengths)))


def _pipelines(corpus, transport, reader=None, bucket_run=1):
    kw = dict(batch_size=4, frame_range=(20, 40), n_buckets=3, seed=5, num_workers=2,
              transport=transport, bucket_run=bucket_run)
    port = PP.AudioTrainPipeline(SpeakerManifest.load(corpus), reader=reader or read_wav, **kw)
    ref = JP.AudioTrainPipeline(JaxManifest.load(corpus), reader=jax_read_wav, **kw)
    return port, ref


@pytest.mark.parametrize("transport", ["float32", "int16", "auto"])
def test_train_pipeline_batches_bit_equal_jax(corpus, transport):
    port, ref = _pipelines(corpus, transport)
    assert port.batches_per_epoch() == ref.batches_per_epoch() > 1
    for epoch in (1, 2):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == port.batches_per_epoch()
        for g, w in zip(got, want):
            assert g["n_frames"] == w["n_frames"]
            assert g["pcm"].dtype == w["pcm"].dtype == (
                np.float32 if transport == "float32" else np.int16)
            np.testing.assert_array_equal(g["pcm"], w["pcm"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
    assert port._resolve_transport() == ref._resolve_transport()


def test_int16_batches_rescale_to_the_float32_batches(corpus):
    f32, _ = _pipelines(corpus, "float32")
    i16, _ = _pipelines(corpus, "int16")
    for a, b in zip(f32.epoch(1), i16.epoch(1)):
        np.testing.assert_array_equal(a["pcm"], b["pcm"].astype(np.float32) / 32768.0)


def test_auto_transport_needs_the_stock_reader(corpus):
    def reader(path, start=0, stop=None):
        return read_wav(path, start, stop)

    port, _ = _pipelines(corpus, "auto", reader=reader)
    assert port._resolve_transport() == "float32"
    assert next(iter(port.epoch(1)))["pcm"].dtype == np.float32


def test_assemble_speaker_crop_matches_jax(corpus):
    spk = SpeakerManifest.load(corpus).speakers[1]
    jspk = JaxManifest.load(corpus).speakers[1]
    got = PP.assemble_speaker_crop(np.random.default_rng(9), spk, 40000, read_wav, [])
    want = JP.assemble_speaker_crop(np.random.default_rng(9), jspk, 40000, jax_read_wav, [])
    assert len(got) == 40000   # longer than any one utterance: pieces concatenated
    np.testing.assert_array_equal(got, want)
    assert os.path.exists(spk[0].path)
