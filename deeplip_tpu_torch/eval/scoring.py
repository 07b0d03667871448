"""Trial-list verification scoring as batched tensor math.

Counterpart of ``deeplip_tpu/eval/scoring.py``: the unique utterances of a
trial list become one embedding matrix ``(N, D)``, rows are L2-normalised,
the ``(M, 2)`` trial index pairs are gathered and each pair scored by one
row-wise dot, on the device. The EER on those scores is the reference
formula (:func:`deeplip_tpu_torch.eval.eer.eer_from_scores`).

``EmbeddingStore`` holds tensors where they were computed (on the card for
the extractor's output) and reads/writes the reference's on-disk layout,
one ``.npy`` per utterance, and Kaldi x-vector ark/scp tables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np
import torch

from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.eval.eer import eer_from_scores
from deeplip_tpu_torch.interop.kaldi import read_scp, write_ark_scp


@dataclass
class TrialList:
    """A verification trial list: ``<0|1> <utt1> <utt2>`` per line."""

    labels: np.ndarray  # (M,) int8
    utt1: list[str]
    utt2: list[str]

    @classmethod
    def load(cls, path: str) -> "TrialList":
        labels, u1, u2 = [], [], []
        with open(path, "r") as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                lab, a, b = line.split(" ")
                labels.append(int(lab))
                u1.append(a)
                u2.append(b)
        return cls(np.asarray(labels, np.int8), u1, u2)

    @property
    def unique_utts(self) -> list[str]:
        seen: dict[str, None] = {}
        for u in self.utt1 + self.utt2:
            seen.setdefault(u)
        return list(seen)

    def index_pairs(self, utt_index: Mapping[str, int]) -> np.ndarray:
        return np.asarray(
            [[utt_index[a], utt_index[b]] for a, b in zip(self.utt1, self.utt2)],
            np.int64)

    def __len__(self) -> int:
        return len(self.labels)


@dataclass
class EmbeddingStore:
    """utterance-name -> embedding tensor, with reference-layout npy IO."""

    table: dict[str, torch.Tensor] = field(default_factory=dict)

    def __setitem__(self, utt: str, emb) -> None:
        self.table[utt] = torch.as_tensor(emb).reshape(-1)

    def __getitem__(self, utt: str) -> torch.Tensor:
        return self.table[utt]

    def __contains__(self, utt: str) -> bool:
        return utt in self.table

    def __len__(self) -> int:
        return len(self.table)

    def matrix(self, utts: Iterable[str]) -> torch.Tensor:
        return torch.stack([self.table[u] for u in utts])

    def save_npy_tree(self, root: str) -> None:
        """One ``<root>/<utt without its .wav suffix>.npy`` per utterance."""
        for utt, emb in self.table.items():
            path = os.path.join(root, utt.removesuffix(".wav") + ".npy")
            os.makedirs(os.path.dirname(path) or root, exist_ok=True)
            np.save(path, emb.detach().cpu().numpy())

    @classmethod
    def load_npy_tree(cls, root: str, utts: Iterable[str]) -> "EmbeddingStore":
        store = cls()
        for utt in utts:
            store[utt] = np.load(os.path.join(root, utt.removesuffix(".wav") + ".npy"))
        return store

    def save_kaldi(self, ark_path: str, scp_path: str | None = None) -> None:
        """One float32 ``FV`` record per utterance, in insertion order."""
        write_ark_scp({u: e.detach().cpu().numpy() for u, e in self.table.items()},
                      ark_path, scp_path)

    @classmethod
    def load_kaldi(cls, scp_path: str) -> "EmbeddingStore":
        store = cls()
        for utt, vec in read_scp(scp_path):
            store[utt] = vec
        return store


def cosine_scores(embeddings: torch.Tensor, pairs: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """``(N, D) x (M, 2) -> (M,)`` cosine similarity of gathered pairs."""
    e = embeddings
    if normalize:
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp(min=1e-12)
    a = e.index_select(0, pairs[:, 0])
    b = e.index_select(0, pairs[:, 1])
    return (a * b).sum(dim=-1)


def cosine_scores_np(embeddings: np.ndarray, pairs: np.ndarray,
                     normalize: bool = True) -> np.ndarray:
    """Host (numpy float32) twin of :func:`cosine_scores`."""
    e = np.asarray(embeddings, np.float32)
    if normalize:
        e = e / np.linalg.norm(e, axis=-1, keepdims=True).clip(1e-12)
    a = e[np.asarray(pairs)[:, 0]]
    b = e[np.asarray(pairs)[:, 1]]
    return np.sum(a * b, axis=-1)


def trial_matrix_pairs(trials: TrialList, store: EmbeddingStore
                       ) -> tuple[torch.Tensor, np.ndarray]:
    """The unique-utterance embedding matrix and the (M, 2) index pairs of
    the trial list."""
    utts = trials.unique_utts
    index = {u: i for i, u in enumerate(utts)}
    return store.matrix(utts), trials.index_pairs(index)


def _trial_scores(trials: TrialList, store: EmbeddingStore,
                  device: str | torch.device | None = None) -> np.ndarray:
    dev = resolve_device(device)
    emb, pairs = trial_matrix_pairs(trials, store)
    scores = cosine_scores(emb.to(dev, torch.float32),
                           torch.from_numpy(pairs).to(dev))
    return scores.cpu().numpy()


def cosine_eer(trials: TrialList, store: EmbeddingStore,
               device: str | torch.device | None = None) -> tuple[float, float]:
    """Cosine back-end EER over a trial list, scored on ``device``
    (default: the card)."""
    return eer_from_scores(trials.labels, _trial_scores(trials, store, device))


def score_fusion_eer(trials: TrialList, audio_store: EmbeddingStore,
                     video_store: EmbeddingStore, audio_weight: float = 0.5,
                     video_weight: float = 0.5,
                     device: str | torch.device | None = None) -> tuple[float, float]:
    """Late score-level fusion: the weighted sum of the two modalities'
    cosines."""
    sa = _trial_scores(trials, audio_store, device)
    sv = _trial_scores(trials, video_store, device)
    return eer_from_scores(trials.labels, audio_weight * sa + video_weight * sv)


def feature_normalize(vec: np.ndarray) -> np.ndarray:
    """Z-norm across the embedding's own dimensions (population std)."""
    return (vec - np.mean(vec, axis=0)) / np.std(vec, axis=0)


def feature_fusion_eer(trials: TrialList, audio_store: EmbeddingStore,
                       video_store: EmbeddingStore,
                       device: str | torch.device | None = None) -> tuple[float, float]:
    """Embedding-level fusion: per-modality z-norm on the host, concat
    ``[video, audio]``, cosine."""
    dev = resolve_device(device)
    utts = trials.unique_utts
    index = {u: i for i, u in enumerate(utts)}

    def normed(store):
        return np.stack([feature_normalize(store[u].detach().cpu().numpy().reshape(-1))
                         for u in utts])

    fused = np.concatenate([normed(video_store), normed(audio_store)], axis=1)
    scores = cosine_scores(torch.from_numpy(fused.astype(np.float32)).to(dev),
                           torch.from_numpy(trials.index_pairs(index)).to(dev))
    return eer_from_scores(trials.labels, scores.cpu().numpy())
