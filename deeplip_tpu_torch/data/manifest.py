"""Training manifests: speaker-grouped utterance lists.

A copy of ``deeplip_tpu/data/manifest.py``, which the port cannot import:
``deeplip_tpu.data`` pulls in JAX. Format-compatible with the reference's
manifest CSV (rows ``sid, aid, filename, duration, samplerate`` grouped by
consecutive speaker id), with the epoch length derived from the total
corpus duration the same way (``floor(total_duration /
mean_crop_duration)``).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass


@dataclass
class Utterance:
    path: str
    duration: float
    rate: int


class SpeakerManifest:
    """Speaker-indexed view of a manifest CSV."""

    def __init__(self, speakers: list[list[Utterance]]):
        self.speakers = speakers

    @classmethod
    def load(cls, path: str) -> "SpeakerManifest":
        speakers: list[list[Utterance]] = []
        current_sid = None
        with open(path, "r") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                sid, _aid, filename, duration, samplerate = row
                if sid != current_sid:
                    speakers.append([])
                    current_sid = sid
                speakers[-1].append(Utterance(filename, float(duration), int(samplerate)))
        return cls(speakers)

    @property
    def n_spk(self) -> int:
        return len(self.speakers)

    @property
    def n_utts(self) -> int:
        return sum(len(s) for s in self.speakers)

    @property
    def total_duration(self) -> float:
        return sum(u.duration for s in self.speakers for u in s)

    def epoch_length(self, mean_frames: float, win_len: float, win_shift: float) -> int:
        """Samples per epoch ≙ ``datasets.py:42-44``."""
        mean_crop = (mean_frames - 1.0) * win_shift + win_len
        return int(self.total_duration / mean_crop)

    def all_utterances(self) -> list[tuple[int, Utterance]]:
        return [(s, u) for s, spk in enumerate(self.speakers) for u in spk]


def write_manifest(path: str, speakers: list[list[Utterance]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for sid, utts in enumerate(speakers):
            for aid, u in enumerate(utts):
                w.writerow([sid, aid, u.path, u.duration, u.rate])
