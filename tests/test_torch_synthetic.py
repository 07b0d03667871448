"""The port's synthetic corpora against the JAX package's: for the same seed
every generator writes the same wav bytes, manifests, trial lists and
clips."""

import os

import numpy as np
import pytest
import torch

from deeplip_tpu.data import synthetic as jax_syn
from deeplip_tpu_torch.data import synthetic as syn
from deeplip_tpu_torch.data.manifest import SpeakerManifest

torch.set_num_threads(1)


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _same_tree(port_root, jax_root):
    port, ref = _files(port_root), _files(jax_root)
    assert sorted(port) == sorted(ref) and port
    for name, data in ref.items():
        want = data.replace(str(jax_root).encode(), str(port_root).encode())
        assert port[name] == want, name


@pytest.mark.parametrize("fn", ["synth_utterance", "synth_hard_utterance"])
def test_utterances_equal_jax(fn):
    for seed, spk, dur in ((0, 1000, 0.5), (3, 1007, 1.2)):
        got = getattr(syn, fn)(np.random.default_rng(seed), spk, dur)
        want = getattr(jax_syn, fn)(np.random.default_rng(seed), spk, dur)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn,kw", [
    ("make_audio_corpus", dict(n_spk=3, utts_per_spk=2, duration=0.5, seed=4)),
    ("make_hard_audio_corpus", dict(n_spk=2, utts_per_spk=3, duration=0.4, seed=5,
                                    separation=0.1, noise=0.5))])
def test_audio_corpora_and_trial_lists_equal_jax(tmp_path, fn, kw):
    port_root, jax_root = tmp_path / "p", tmp_path / "j"
    path, manifest = getattr(syn, fn)(str(port_root), **kw)
    jpath, jmanifest = getattr(jax_syn, fn)(str(jax_root), **kw)
    assert path == str(port_root / "manifest.csv")
    assert isinstance(manifest, SpeakerManifest) and manifest.n_spk == jmanifest.n_spk
    for n_trials, balance in ((50, None), (40, 0.5)):
        syn.make_trial_list(str(port_root / f"trials{n_trials}.txt"), manifest,
                            n_trials=n_trials, seed=2, balance=balance)
        jax_syn.make_trial_list(str(jax_root / f"trials{n_trials}.txt"), jmanifest,
                                n_trials=n_trials, seed=2, balance=balance)
    _same_tree(port_root, jax_root)


def test_video_clips_and_corpus_equal_jax(tmp_path):
    got = syn.synth_video_clip(np.random.default_rng(1), 2001, t=5, size=32)
    want = jax_syn.synth_video_clip(np.random.default_rng(1), 2001, t=5, size=32)
    assert got.dtype == np.uint8 and got.shape == (5, 32, 32)
    np.testing.assert_array_equal(got, want)
    port = syn.make_video_corpus(str(tmp_path / "p"), n_spk=2, clips_per_spk=2, t=4, size=24,
                                 seed=3)
    ref = jax_syn.make_video_corpus(str(tmp_path / "j"), n_spk=2, clips_per_spk=2, t=4,
                                    size=24, seed=3)
    assert [(os.path.relpath(p, tmp_path / "p"), s) for p, s in port] == [
        (os.path.relpath(p, tmp_path / "j"), s) for p, s in ref]
    for (p, _), (j, _) in zip(port, ref):
        np.testing.assert_array_equal(np.load(p)["data"], np.load(j)["data"])
    _same_tree(tmp_path / "p", tmp_path / "j")
