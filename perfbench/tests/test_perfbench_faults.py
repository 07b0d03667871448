"""A run with its timed path broken underneath comes out not correct.

Each cell runs through the harness on the CPU at a small size (the f32
recipe; the program's plain kernels), first sound, then with one fault
planted in the program: a step that leaves its state unchanged, half of
the batch left out with the mean taken over the rest, and an answer altered
where it is produced. The limits are three times the sound run's readings,
so the sound run passes by construction and each fault has to move a
number past that. (A run on one chip has no exchange between chips to
leave out.)"""

from __future__ import annotations

import pytest
import torch

from perfbench.tests import tiny

CELLS = ("etdnn-score-3s", "etdnn-train-bf16", "lipreading-train-f32")


def _small(cell: str):
    small = tiny.tiny_cell(cell)
    small.traffic["precision"] = "f32"
    small.config.get("train", {})["compute_dtype"] = "float32"
    return small


@pytest.fixture(scope="module")
def sound_limits():
    out = {}
    for cell in CELLS:
        checks = tiny.run_tiny(cell, cell=_small(cell))["checks"]
        out[cell] = {n: max(3 * c["value"], 1e-9) for n, c in checks.items()}
    return out


def _half_embeddings(monkeypatch):
    from deeplip_tpu_torch.train.audio import AudioExtractor

    embed = AudioExtractor.embed

    def half(self, pcm, feat_lengths, sample_lengths):
        emb = embed(self, pcm, feat_lengths, sample_lengths).clone()
        emb[emb.shape[0] // 2:] = 0.0
        return emb

    monkeypatch.setattr(AudioExtractor, "embed", half)


def _altered_score(monkeypatch):
    from deeplip_tpu_torch.eval import scoring

    cosine = scoring.cosine_scores

    def altered(emb, pairs, normalize=True):
        scores = cosine(emb, pairs, normalize)
        return torch.cat([scores[:1] + 0.01, scores[1:]])

    monkeypatch.setattr(scoring, "cosine_scores", altered)


def _frozen_state(monkeypatch):
    from deeplip_tpu_torch.train import state

    monkeypatch.setattr(state.SGD, "step", lambda self, lr=None: None)
    monkeypatch.setattr(state.Adam, "step", lambda self, lr=None: None)


def _half_batch(monkeypatch):
    from deeplip_tpu_torch.train import audio, video

    apply = audio.AudioTrainer._criterion_apply

    def audio_half(self, emb, labels, margin):
        h = emb.shape[0] // 2
        loss, hits = apply(self, emb[:h], labels[:h], margin)
        return loss, torch.cat([hits, hits])

    cross_entropy = video.softmax_cross_entropy

    def video_half(logits, labels, reduction="mean"):
        per = cross_entropy(logits, labels, reduction="none")
        h = max(per.shape[0] // 2, 1)
        weight = torch.zeros_like(per)
        weight[:h] = per.shape[0] / h
        return per * weight

    monkeypatch.setattr(audio.AudioTrainer, "_criterion_apply", audio_half)
    monkeypatch.setattr(video, "softmax_cross_entropy", video_half)


def _altered_loss(monkeypatch):
    from deeplip_tpu_torch.train import audio, video

    for cls in (audio.AudioTrainer, video.VideoTrainer):
        step = cls.train_step

        def altered(self, *args, _step=step):
            out = dict(_step(self, *args))
            out["loss"] = out["loss"] * 1.1
            return out

        monkeypatch.setattr(cls, "train_step", altered)


FAULTS = {
    "etdnn-score-3s": {"half_batch": _half_embeddings, "answer_altered": _altered_score},
    "etdnn-train-bf16": {"state_unchanged": _frozen_state, "half_batch": _half_batch,
                         "answer_altered": _altered_loss},
    "lipreading-train-f32": {"state_unchanged": _frozen_state, "half_batch": _half_batch,
                             "answer_altered": _altered_loss},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(cell, fault, sound_limits, monkeypatch):
    limits = sound_limits[cell]
    FAULTS[cell][fault](monkeypatch)
    result = tiny.run_tiny(cell, cell=_small(cell), limits=limits)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_is_correct_under_those_limits(cell, sound_limits):
    result = tiny.run_tiny(cell, cell=_small(cell), limits=sound_limits[cell])
    assert result["correct"] is True, result["checks"]
