"""Paired audio-visual training batches.

Counterpart of ``deeplip_tpu/data/fusion_pipeline.py``. Batches are
speaker-balanced as the audio pipeline's: per batch a crop length from the
bucket grid, per sampled speaker a random crop-and-concat of its utterances
(:func:`deeplip_tpu_torch.data.audio_pipeline.assemble_speaker_crop`). The
first utterance a crop draws is the one its video pairs with: its clip
group (a map utterance path -> clip ``.npz`` paths) is padded into a dense
``(B, G, T, H, W)`` uint8 tensor with per-clip frame counts and per-item
group sizes, so the fusion train step embeds every clip of the batch in
one pass. An item with no clip keeps group size 0, and the step leaves it
out of the loss. The numpy draws are the JAX package's, so the batches are
bit-equal to its pipeline's for the same manifest, map and seed.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping, Sequence

import numpy as np

from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.audio_pipeline import assemble_speaker_crop
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.prefetch import ThreadedPrefetcher
from deeplip_tpu_torch.data.sampler import SpeakerBatchSampler
from deeplip_tpu_torch.data.video_dataset import load_clip
from deeplip_tpu_torch.ops.framing import samples_for_frames


class AVTrainPipeline:
    """Speaker-balanced paired (PCM, clip-group) batches, assembled on host
    threads."""

    def __init__(
        self,
        manifest: SpeakerManifest,
        video_map: Mapping[str, Sequence[str]],
        batch_size: int,
        frame_range: tuple[int, int] = (200, 400),
        win_len: float = 0.025,
        win_shift: float = 0.01,
        rate: int = 16000,
        n_buckets: int = 5,
        max_clips: int = 2,
        clip_frames: int = 16,
        seed: int = 0,
        num_workers: int = 4,
        reader: Callable = read_wav,
    ):
        self.manifest = manifest
        self.video_map = dict(video_map)
        self.rate = rate
        self.win_len = win_len
        self.win_shift = win_shift
        self.max_clips = max_clips
        self.clip_frames = clip_frames
        self.reader = reader
        self.num_workers = num_workers
        epoch_len = manifest.epoch_length(np.mean(frame_range), win_len, win_shift)
        self.sampler = SpeakerBatchSampler(
            manifest.n_spk, max(epoch_len, batch_size), batch_size,
            frame_range, n_buckets, seed)

    @property
    def n_spk(self) -> int:
        return self.manifest.n_spk

    def batches_per_epoch(self) -> int:
        return self.sampler.batches_per_epoch()

    def _assemble(self, sids, n_frames: int, seed) -> dict:
        rng = np.random.default_rng(seed)
        samples_num = samples_for_frames(n_frames, self.win_len, self.win_shift, self.rate)
        b = len(sids)
        pcm = np.zeros((b, samples_num), np.float32)
        clips = None  # sized from the first clip's H, W
        clip_lengths = np.zeros((b, self.max_clips), np.int32)
        group_sizes = np.zeros((b,), np.int32)
        for row, sid in enumerate(sids):
            first: list = []
            pcm[row] = assemble_speaker_crop(rng, self.manifest.speakers[sid], samples_num,
                                             self.reader, first_utt_out=first)
            paths = list(self.video_map.get(first[0].path, ()))[:self.max_clips]
            for g, path in enumerate(paths):
                data = load_clip(path)[:self.clip_frames]
                if clips is None:
                    h, w = data.shape[1:]
                    clips = np.zeros((b, self.max_clips, self.clip_frames, h, w), np.uint8)
                clips[row, g, :len(data)] = data
                clip_lengths[row, g] = len(data)
            group_sizes[row] = len(paths)
        if clips is None:
            clips = np.zeros((b, self.max_clips, self.clip_frames, 1, 1), np.uint8)
        return {"pcm": pcm, "clips": clips, "clip_lengths": clip_lengths,
                "group_sizes": group_sizes, "labels": np.asarray(sids, np.int64),
                "n_frames": n_frames}

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        """Yields ``{pcm (B, S), clips (B, G, T, H, W), clip_lengths (B, G),
        group_sizes (B,), labels (B,), n_frames}`` for one epoch."""
        schedule = [(sids, n_frames, (self.sampler.seed, epoch_idx, i))
                    for i, (sids, n_frames) in enumerate(self.sampler.epoch(epoch_idx))]
        yield from ThreadedPrefetcher(schedule, self._assemble, num_workers=self.num_workers)
