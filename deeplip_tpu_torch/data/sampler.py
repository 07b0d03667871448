"""Speaker-balanced sampling and shape-bucketed crop lengths.

Counterpart of ``deeplip_tpu/data/sampler.py``, with the same numpy draws
(``default_rng((seed, epoch))``), so speaker ids and crop lengths equal the
JAX package's for the same seed.

The reference's training Dataset yields *speaker ids* (``__getitem__``
returns ``idx % n_spk``) which a shuffled DataLoader turns into
speaker-balanced batches; the collate function then draws one random crop
length per batch, uniform over ``frames ∈ [200, 400]``. :func:`frame_buckets`
quantizes that draw onto a small grid (11 lengths by default), so the card
sees a handful of shapes: cuDNN picks its algorithms once per shape.
"""

from __future__ import annotations

import numpy as np


def frame_buckets(lo: int, hi: int, n_buckets: int = 11) -> np.ndarray:
    """Evenly spaced crop lengths covering [lo, hi] inclusive."""
    return np.unique(np.linspace(lo, hi, n_buckets).round().astype(int))


class SpeakerBatchSampler:
    """Yields ``(speaker_ids, n_frames)`` batches for one epoch.

    Speaker ids follow the reference's ``shuffled(range(epoch_len)) % n_spk``
    scheme; ``n_frames`` is drawn per batch from the bucket grid.
    """

    def __init__(
        self,
        n_spk: int,
        epoch_length: int,
        batch_size: int,
        frame_range: tuple[int, int] = (200, 400),
        n_buckets: int = 11,
        seed: int = 0,
        bucket_run: int = 1,
    ):
        self.n_spk = n_spk
        self.epoch_length = epoch_length
        self.batch_size = batch_size
        self.buckets = frame_buckets(frame_range[0], frame_range[1], n_buckets)
        self.seed = seed
        # crop length redrawn every `bucket_run` batches (1 = reference
        # behavior, per batch). Runs of a shared length are what grouped
        # step dispatch needs; lengths remain uniform over the bucket grid,
        # just correlated within a run.
        self.bucket_run = max(int(bucket_run), 1)

    def epoch(self, epoch_idx: int):
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(self.epoch_length) % self.n_spk
        n_frames = None
        for b in range(self.batches_per_epoch()):
            ids = order[b * self.batch_size : (b + 1) * self.batch_size]
            if b % self.bucket_run == 0:
                n_frames = int(rng.choice(self.buckets))
            yield ids, n_frames

    def batches_per_epoch(self) -> int:
        """Whole batches only: the last partial batch is dropped."""
        return self.epoch_length // self.batch_size
