"""Video clip dataset: npz/npy mouth-ROI clips in length-bucketed batches.

Counterpart of ``deeplip_tpu/data/video_dataset.py``. Clips are found as
``<root>/<speaker>/<clip>.npz|npy`` (label = the speaker directory), read
as ``(T, H, W)`` uint8 (``np.load(...)['data']``), bucketed by temporal
length (rounded up to ``bucket_t``), padded with zeros and shipped as uint8
``(B, T, H, W)`` batches with their true lengths. The shuffle, the bucket
sort and the batch assembly are the JAX package's, so both give the same
batches. Clips load through the native threaded npz reader
(``deeplip_tpu_torch.native``) where it is built, else on a thread pool
with ``np.load``; the clip lengths come from the headers alone.
"""

from __future__ import annotations

import glob
import os
import warnings
import zipfile
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
from numpy.lib import format as npf

from deeplip_tpu_torch import native
from deeplip_tpu_torch.data.prefetch import ThreadedPrefetcher


@dataclass
class VideoClip:
    path: str
    label: int
    name: str  # e.g. 'spk01/clip3'


def scan_clip_dir(data_dir: str, label_list: Sequence[str] | None = None) -> list[VideoClip]:
    """Discover clips; label = index of the speaker directory name, in
    ``label_list`` order if given, else in sorted order."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*", "*.npz"))
                   + glob.glob(os.path.join(data_dir, "*", "*.npy")))
    speakers = sorted({p.split(os.sep)[-2] for p in paths})
    index = {s: i for i, s in enumerate(label_list if label_list is not None else speakers)}
    clips = []
    for p in paths:
        spk = p.split(os.sep)[-2]
        name = os.path.join(spk, os.path.splitext(os.path.basename(p))[0])
        clips.append(VideoClip(p, index[spk], name))
    return clips


def _squeeze_channel(data: np.ndarray) -> np.ndarray:
    if data.ndim == 4 and data.shape[-1] == 1:
        data = data[..., 0]
    return np.ascontiguousarray(data)


def load_clip(path: str) -> np.ndarray:
    """``(T, H, W)`` uint8 frames from npz (key ``'data'``) or npy."""
    data = np.load(path)["data"] if path.endswith(".npz") else np.load(path)
    return _squeeze_channel(data)


def load_clips(paths: Sequence[str], num_threads: int = 4) -> list[np.ndarray]:
    """Load clips on ``num_threads`` threads, in the order given: through the
    native npz reader (zip walk, inflate and header parse in C++, without
    the GIL) where it is built, else ``np.load``."""
    if native.npy_available():
        try:
            return [_squeeze_channel(a)
                    for a in native.read_npy_batch(list(paths), n_threads=num_threads)]
        except (IOError, ValueError) as exc:
            # an unusual container (zip64, Fortran order): keep the fallback
            # threaded, a serial np.load loop would slow epochs silently
            warnings.warn(f"native npz reader fell back to np.load: {exc}")
    return list(ThreadedPrefetcher(list(paths), load_clip, num_workers=num_threads))


def _probe_clip_length(path: str) -> int:
    """Frame count from the npy/npz header only (no payload read)."""
    try:
        if path.endswith(".npz"):
            with zipfile.ZipFile(path) as z, z.open("data.npy") as f:
                shape, _, _ = npf._read_array_header(f, npf.read_magic(f))
        else:
            with open(path, "rb") as f:
                shape, _, _ = npf._read_array_header(f, npf.read_magic(f))
        return int(shape[0])
    except Exception:  # private-API drift or an odd container: full load
        return int(len(load_clip(path)))


class VideoClipBatches:
    """Length-bucketed uint8 clip batches for training or extraction."""

    def __init__(self, clips: Sequence[VideoClip], batch_size: int = 32,
                 bucket_t: int = 8, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, max_frames: int | None = None,
                 pre_crop: tuple[int, int] | None = None):
        self.clips = list(clips)
        self.batch_size = batch_size
        self.bucket_t = bucket_t
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.max_frames = max_frames
        # extraction only: centre-crop on the host before shipping (the
        # device's centre crop then slices nothing); training batches need
        # the full frame for the random crop
        self.pre_crop = tuple(pre_crop) if pre_crop else None

    @property
    def n_classes(self) -> int:
        return max(c.label for c in self.clips) + 1

    def _bucket(self, t: int) -> int:
        return -(-t // self.bucket_t)

    def _probe_lengths(self, clips: Sequence[VideoClip]) -> list[int]:
        """Clip frame counts from the headers alone: the native probe, else
        a zipfile/npy-header read."""
        if native.npy_available():
            try:
                shapes = native.probe_npy_shapes([c.path for c in clips],
                                                 n_threads=self.num_workers)
                return [int(shape[0]) for shape, _ in shapes]
            except (IOError, ValueError):
                pass
        return list(ThreadedPrefetcher(clips, lambda c: _probe_clip_length(c.path),
                                       num_workers=self.num_workers))

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        """Length-bucketed batches, streamed: a header scan buckets the
        clips, then each batch's payloads load one batch ahead."""
        order = np.arange(len(self.clips))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch_idx)).shuffle(order)
        clips = [self.clips[i] for i in order]
        lengths = self._probe_lengths(clips)
        if self.max_frames:
            lengths = [min(t, self.max_frames) for t in lengths]
        items = list(zip(clips, lengths))
        # stable sort by bucket only: within a bucket the shuffled order
        # survives, so epochs see different batch compositions
        items.sort(key=lambda it: self._bucket(it[1]))

        specs: list[list[tuple[VideoClip, int]]] = []
        i = 0
        while i < len(items):
            bucket = self._bucket(items[i][1])
            chunk = [it for it in items[i:i + self.batch_size]
                     if self._bucket(it[1]) == bucket]
            i += len(chunk)
            specs.append(chunk)

        def build(chunk):
            arrays = load_clips([c.path for c, _ in chunk], num_threads=self.num_workers)
            if self.max_frames:
                arrays = [a[:self.max_frames] for a in arrays]
            if self.pre_crop:
                # the offsets of ops.video.center_crop, so the two compose exactly
                th, tw = self.pre_crop
                h0, w0 = arrays[0].shape[1:]
                dh = int(round((h0 - th)) / 2.0)
                dw = int(round((w0 - tw)) / 2.0)
                arrays = [a[:, dh:dh + th, dw:dw + tw] for a in arrays]
            bucket_frames = max(self._bucket(t) * self.bucket_t for _, t in chunk)
            h, w = arrays[0].shape[1:]
            batch = np.zeros((len(chunk), bucket_frames, h, w), np.uint8)
            lens = np.zeros((len(chunk),), np.int32)
            labels = np.zeros((len(chunk),), np.int64)
            names = []
            for row, ((clip, _), data) in enumerate(zip(chunk, arrays)):
                batch[row, :len(data)] = data
                lens[row] = len(data)
                labels[row] = clip.label
                names.append(clip.name)
            return {"clips": batch, "lengths": lens, "labels": labels, "names": names}

        yield from ThreadedPrefetcher(specs, build, num_workers=1, lookahead=2)
