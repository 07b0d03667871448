"""The slice as a whole: wav corpus → bucketed batches → embeddings → EER,
through the JAX package and through the port with the same weights.

A small ragged PCM16 corpus is written to ``tmp_path``. The JAX
``AudioTrainer`` (8-device CPU mesh) and the port's ``AudioExtractor`` (on
the CPU, where the front-end kernel's wrapper runs its plain version) embed
it with weights carried across by ``interop.from_jax``; embeddings agree to
1e-4 per utterance. ``n_buckets`` is 2 to bound the JAX compiles.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.core.mesh import make_mesh
from deeplip_tpu.data.audio_pipeline import EvalUtterance as JaxUtterance
from deeplip_tpu.data.audio_pipeline import EvalUtteranceSet as JaxEvalSet
from deeplip_tpu.data.audio_pipeline import eval_set_kwargs as jax_eval_set_kwargs
from deeplip_tpu.eval.scoring import cosine_scores_np as jax_cosine_scores_np
from deeplip_tpu.ops.features import FeatureConfig as JaxFeatureConfig
from deeplip_tpu.train.audio import AudioTrainer
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.data.audio_io import write_wav
from deeplip_tpu_torch.data.audio_pipeline import (EvalUtterance, EvalUtteranceSet,
                                                   eval_set_kwargs)
from deeplip_tpu_torch.eval.scoring import TrialList, cosine_scores, trial_matrix_pairs
from deeplip_tpu_torch.interop.from_jax import speaker_embnet_state_dict
from deeplip_tpu_torch.ops.features import FeatureConfig
from deeplip_tpu_torch.train.audio import AudioExtractor

torch.set_num_threads(1)

TINY_MODEL = {
    "arch": "tdnn",
    "tdnn": {
        "input_dim": 24,
        "hidden_dim": [48, 48, 48, 48, 96],
        "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [-3, 0, 3], [0], [0]],
        "tdnn_layers": 5,
        "embedding_dim": 32,
        "pooling": "statistic",
        "bn_first": True,
    },
}
DATA = {"python_data_config": {
    "rate": 16000, "feat_type": "mfcc",
    "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
             "normalize": True, "delta": False, "win_len": 0.025,
             "win_shift": 0.01}}}
TEST_OPTS = {"batch_size": 4, "n_buckets": 2, "matmul_precision": "highest"}


def _config(loss):
    return {"data": DATA, "model": TINY_MODEL,
            "train": {"loss": loss, "type": "sgd", "bs": 8},
            "test": TEST_OPTS}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 ragged (0.6–2.0 s) PCM16 wavs of 4 synthetic speakers, and a trial
    list over them."""
    root = tmp_path_factory.mktemp("torch_corpus")
    rng = np.random.default_rng(0)
    names = []
    for i in range(10):
        spk = i % 4
        n = int(rng.integers(9600, 32000))
        t = np.arange(n) / 16000.0
        y = (0.3 * np.sin(2 * np.pi * (120 + 40 * spk) * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        name = f"spk{spk}/u{i}.wav"
        os.makedirs(root / f"spk{spk}", exist_ok=True)
        write_wav(str(root / name), y, 16000)
        names.append(name)
    trials = root / "trials.txt"
    with open(trials, "w") as f:
        for a in range(10):
            for b in range(a + 1, 10):
                same = int(names[a].split("/")[0] == names[b].split("/")[0])
                f.write(f"{same} {names[a]} {names[b]}\n")
    return str(root), names, str(trials)


def _sets(corpus, transport):
    root, names, _ = corpus
    kw = dict(batch_size=4, n_buckets=2, num_workers=2, transport=transport)
    jset = JaxEvalSet([JaxUtterance(n, os.path.join(root, n)) for n in names], **kw)
    tset = EvalUtteranceSet([EvalUtterance(n, os.path.join(root, n)) for n in names], **kw)
    return jset, tset


@pytest.mark.parametrize("transport", ["auto", "float32", "int16"])
def test_eval_batches_equal(corpus, transport):
    jset, tset = _sets(corpus, transport)
    jb, tb = list(jset.batches()), list(tset.batches())
    assert len(jb) == len(tb) > 1
    for j, t in zip(jb, tb):
        assert set(j) == set(t)
        assert j["names"] == t["names"]
        for key in ("pcm", "feat_lengths", "sample_lengths"):
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    if transport == "auto":
        assert tset._resolved_transport == jset._resolved_transport == "int16"


def test_eval_set_kwargs_match():
    for opts in ({}, {"batch_size": 8, "n_buckets": 0, "transport": "int16"}):
        want = jax_eval_set_kwargs(JaxFeatureConfig(), opts)
        assert eval_set_kwargs(FeatureConfig(), opts) == want


def _randomised_state(trainer, seed):
    """The trainer's initial state with non-trivial BN parameters and
    running statistics, as numpy trees."""
    state = trainer.ensure_state()
    params = jax.tree_util.tree_map(np.asarray, state.params["model"])
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats["model"])
    rng = np.random.default_rng(seed)

    def visit(p, s):
        for name, sub in p.items():
            if "scale" in sub:
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[name]["mean"] = rng.normal(0, 0.5, c).astype(np.float32)
                s[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(sub, dict):
                visit(sub, s.setdefault(name, {}))

    visit(params, stats)
    trainer.state = state.replace(
        params={**state.params, "model": params},
        batch_stats={"model": stats})
    return params, stats


@pytest.mark.parametrize("loss", ["LMCL", "CrossEntropy"])
def test_extraction_matches_jax(corpus, tmp_path, loss):
    root, names, trial_path = corpus
    trainer = AudioTrainer(JaxConfig(_config(loss)), mesh=make_mesh(),
                           exp_root=str(tmp_path / "exp"), n_spk=4)
    params, stats = _randomised_state(trainer, seed=3)
    extractor = AudioExtractor(Config(_config(loss)), device="cpu")
    extractor.load_state_dict(speaker_embnet_state_dict(params, stats))

    jset = JaxEvalSet([JaxUtterance(n, os.path.join(root, n)) for n in names],
                      num_workers=2, **jax_eval_set_kwargs(trainer.feat_cfg, TEST_OPTS))
    tset = EvalUtteranceSet([EvalUtterance(n, os.path.join(root, n)) for n in names],
                            num_workers=2, **eval_set_kwargs(extractor.feat_cfg, TEST_OPTS))
    want = trainer.extract_embeddings(jset)
    got = extractor.extract_embeddings(tset)
    assert len(got) == len(want) == len(names)
    for n in names:
        assert got[n].device.type == "cpu"
        np.testing.assert_allclose(got[n].numpy(), want[n], atol=1e-4, err_msg=n)

    trials = TrialList.load(trial_path)
    emb, pairs = trial_matrix_pairs(trials, got)
    scores = cosine_scores(emb, torch.from_numpy(pairs)).numpy()
    want_scores = jax_cosine_scores_np(
        np.stack([want[u] for u in trials.unique_utts]), pairs)
    np.testing.assert_allclose(scores, want_scores, atol=1e-4)
    eer, _ = extractor.evaluate(trial_path, got)
    assert 0.0 <= eer <= 1.0
