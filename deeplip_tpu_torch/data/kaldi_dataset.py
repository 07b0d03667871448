"""Kaldi-format training input: precomputed features from ark/scp tables.

Counterpart of ``deeplip_tpu/data/kaldi_dataset.py`` (``data_format:
kaldi``): ``nn_spk2utt`` groups utterances by speaker, ``nn_feat_scp``
locates their feature matrices. Per batch a crop length is drawn from the
bucket grid (``data.sampler``), and per sampled speaker random utterance
crops are concatenated until the crop is full: the wav pipeline's
speaker-balanced semantics on precomputed features, so the train step runs
no front-end. The draws are the JAX package's (one generator per ``(seed,
epoch, batch)``), so the batches are bit-equal to its pipeline's.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from deeplip_tpu_torch.data.prefetch import ThreadedPrefetcher
from deeplip_tpu_torch.data.sampler import SpeakerBatchSampler
from deeplip_tpu_torch.interop.kaldi import read_ark_entry


def read_spk2utt(path: str) -> dict[str, list[str]]:
    """``<spk> <utt1> <utt2> ...`` per line."""
    out: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def read_scp_index(path: str) -> dict[str, tuple[str, int]]:
    """``<utt> <ark>:<offset>`` per line -> utt -> (ark_path, offset)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, loc = line.split(" ", 1)
            ark, off = loc.rsplit(":", 1)
            out[utt] = (ark, int(off))
    return out


class KaldiTrainPipeline:
    """Speaker-balanced random-crop batches of precomputed features:
    ``{feats (B, T, D) float32, labels (B,), n_frames}``. Speakers with no
    utterance in the scp are dropped, and the labels index the rest."""

    def __init__(self, spk2utt_path: str, feat_scp_path: str, batch_size: int,
                 frame_range: tuple[int, int] = (200, 400), n_buckets: int = 11,
                 epoch_length: int | None = None, seed: int = 0, num_workers: int = 4):
        spk2utt = read_spk2utt(spk2utt_path)
        index = read_scp_index(feat_scp_path)
        speakers = [[index[u] for u in utts if u in index] for utts in spk2utt.values()]
        self.speakers = [s for s in speakers if s]
        n_utts = sum(len(s) for s in self.speakers)
        self.sampler = SpeakerBatchSampler(
            len(self.speakers), epoch_length or max(n_utts, batch_size), batch_size,
            frame_range, n_buckets, seed)
        self.num_workers = num_workers
        ark, off = self.speakers[0][0]
        self.feat_dim = read_ark_entry(ark, off).shape[1]

    @property
    def n_spk(self) -> int:
        return len(self.speakers)

    def batches_per_epoch(self) -> int:
        return self.sampler.batches_per_epoch()

    def _assemble(self, sids, n_frames: int, seed) -> dict:
        rng = np.random.default_rng(seed)
        feats = np.zeros((len(sids), n_frames, self.feat_dim), np.float32)
        for row, sid in enumerate(sids):
            speaker = self.speakers[sid]
            pieces, n, attempts = [], 0, 0
            while n < n_frames:
                ark, off = speaker[rng.integers(0, len(speaker))]
                mat = read_ark_entry(ark, off)
                start = rng.integers(0, max(len(mat) - 1, 1))
                pieces.append(mat[start:])
                n += len(mat) - start
                attempts += 1
                if n == 0 and attempts >= 8 * len(speaker):
                    # every sampled matrix empty: a failed feature extraction
                    # upstream must not hang the prefetch worker forever
                    raise ValueError(
                        f"speaker {sid}: all sampled kaldi feature matrices "
                        "are empty; cannot assemble a crop")
            feats[row] = np.concatenate(pieces)[:n_frames]
        return {"feats": feats, "labels": np.asarray(sids, np.int64), "n_frames": n_frames}

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        schedule = [(sids, n_frames, (self.sampler.seed, epoch_idx, i))
                    for i, (sids, n_frames) in enumerate(self.sampler.epoch(epoch_idx))]
        yield from ThreadedPrefetcher(schedule, self._assemble, num_workers=self.num_workers)
