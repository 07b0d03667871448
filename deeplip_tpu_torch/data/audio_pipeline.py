"""Test-time audio batches: the host assembles raw PCM, the device does DSP.

Counterpart of the evaluation half of ``deeplip_tpu/data/audio_pipeline.py``.
Full test utterances are grouped into length buckets, zero-padded and
batched with valid-length vectors: with VALID convolutions and masked
pooling the padded batch reproduces per-utterance results exactly.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np

from deeplip_tpu_torch.data.audio_io import (read_wav, read_wav_int16,
                                             resample, resampled_length,
                                             wav_format)
from deeplip_tpu_torch.data.prefetch import ThreadedPrefetcher
from deeplip_tpu_torch.ops.framing import (frame_len_step, num_frames,
                                           samples_for_frames)


@dataclass
class EvalUtterance:
    name: str
    path: str


def eval_set_kwargs(feat_cfg, test_opts: dict) -> dict:
    """The one ``test_opts`` → :class:`EvalUtteranceSet` kwargs mapping.

    Defaults: ``n_buckets: 8`` corpus-adaptive bucket edges
    (:func:`optimal_bucket_edges`; ``test.n_buckets: 0`` falls back to
    fixed ``bucket_frames`` quantization) and ``transport: auto`` (int16
    PCM exactly when that is value-exact for the whole corpus).
    """
    kw = dict(
        rate=feat_cfg.rate,
        win_len=feat_cfg.win_len,
        win_shift=feat_cfg.win_shift,
        bucket_frames=int(test_opts.get("bucket_frames", 100)),
        batch_size=int(test_opts.get("batch_size", 64)),
        transport=str(test_opts.get("transport", "auto")),
    )
    n_buckets = test_opts.get("n_buckets")
    n_buckets = 8 if n_buckets is None else int(n_buckets)
    if n_buckets > 0:
        kw["n_buckets"] = n_buckets
    return kw


def optimal_bucket_edges(lengths: Sequence[int], n_buckets: int) -> list[int]:
    """At most ``n_buckets`` bucket lengths minimizing the total pad frames
    ``sum(bucket_len(t) - t)``, each utterance padding up to the smallest
    chosen length >= its own: a 1-D segmentation DP over the sorted unique
    lengths. The top edge is always ``max(lengths)``."""
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    u, c = np.unique(np.asarray(lengths, np.int64), return_counts=True)
    m = len(u)
    if m <= n_buckets:
        return [int(x) for x in u]
    csum = np.concatenate([[0], np.cumsum(c)])
    wsum = np.concatenate([[0], np.cumsum(c * u)])
    # dp[k][j] = min pad cost covering unique lengths [0, j) with k buckets,
    # the k-th bucket top being u[j-1]
    dp = np.full((n_buckets + 1, m + 1), np.inf)
    dp[0, 0] = 0.0
    arg = np.zeros((n_buckets + 1, m + 1), np.int64)
    for k in range(1, n_buckets + 1):
        for j in range(1, m + 1):
            i = np.arange(j)
            cost = u[j - 1] * (csum[j] - csum[i]) - (wsum[j] - wsum[i])
            tot = dp[k - 1, :j] + cost
            b = int(np.argmin(tot))
            dp[k, j] = tot[b]
            arg[k, j] = b
    edges = []
    j = m
    for k in range(n_buckets, 0, -1):
        edges.append(int(u[j - 1]))
        j = int(arg[k, j])
    return sorted(edges)


class EvalUtteranceSet:
    """Length-bucketed batches of full test utterances.

    ``bucket_frames`` quantizes feature lengths upward; ``n_buckets``
    replaces that with corpus-adaptive edges (:func:`optimal_bucket_edges`).

    ``transport="int16"`` ships PCM16 batches (half the float32 bytes; the
    extractor rescales on the device). ``transport="auto"`` resolves during
    the header scan: int16 iff every utterance is an integer-PCM16 WAV at
    the target rate read by the stock reader, where ``i/32768`` gives back
    the exact float32 samples; float32 otherwise.
    """

    def __init__(
        self,
        utts: Sequence[EvalUtterance],
        rate: int = 16000,
        win_len: float = 0.025,
        win_shift: float = 0.01,
        bucket_frames: int = 100,
        batch_size: int = 32,
        reader: Callable = read_wav,
        num_workers: int = 8,
        transport: str = "float32",
        n_buckets: int | None = None,
    ):
        if transport not in ("float32", "int16", "auto"):
            raise ValueError(
                f"transport must be float32|int16|auto, got {transport!r}")
        self.utts = list(utts)
        self.rate = rate
        self.win_len = win_len
        self.win_shift = win_shift
        self.bucket_frames = bucket_frames
        self.n_buckets = n_buckets
        self.batch_size = batch_size
        self.reader = reader
        self.num_workers = num_workers
        self.transport = transport
        # "auto" resolves during the header scan in batches()
        self._resolved_transport = None if transport == "auto" else transport
        self.frame_len, self.frame_step = frame_len_step(win_len, win_shift, rate)

    def _load(self, utt: EvalUtterance) -> tuple[str, np.ndarray]:
        y, sr = self.reader(utt.path)
        if sr != self.rate:
            y = resample(y, sr, self.rate)
        return utt.name, y.astype(np.float32)

    def _load_int16(self, utt: EvalUtterance, s_max: int) -> np.ndarray | None:
        """The stored PCM16 samples, or ``None`` (→ the float path plus
        conversion) when the source is not PCM16 at the target rate or a
        custom reader is installed."""
        if self.reader is not read_wav:
            return None
        try:
            y, sr = read_wav_int16(utt.path, stop=s_max)
        except (ValueError, wave.Error, EOFError):
            return None
        return y if sr == self.rate else None

    def _utt_samples(self, utt: EvalUtterance) -> tuple[EvalUtterance, int, bool]:
        """Sample count after resampling, and int16-transport eligibility for
        ``transport="auto"``, from the header alone."""
        try:
            with wave.open(utt.path, "rb") as w:
                rate, n = w.getframerate(), w.getnframes()
        except (wave.Error, EOFError):
            y, rate = self.reader(utt.path)
            n = len(y)
        i16_ok = False
        if self.transport == "auto" and rate == self.rate and self.reader is read_wav:
            fmt = wav_format(utt.path)
            i16_ok = fmt is not None and fmt[0] == 1 and fmt[1] == 16
        if rate != self.rate:
            n = resampled_length(n, rate, self.rate)
        return utt, n, i16_ok

    def _assemble(self, chunk: list[tuple[EvalUtterance, int, int]]) -> dict:
        bucket_t = chunk[0][2]
        s_max = samples_for_frames(bucket_t, self.win_len, self.win_shift, self.rate)
        i16 = (self._resolved_transport or self.transport) == "int16"
        pcm = np.zeros((len(chunk), s_max), np.int16 if i16 else np.float32)
        lengths = np.zeros((len(chunk),), np.int32)
        sample_lengths = np.zeros((len(chunk),), np.int32)
        names = []
        for row, (utt, t, _) in enumerate(chunk):
            y = self._load_int16(utt, s_max) if i16 else None
            if y is None:
                _, y = self._load(utt)
                y = y[:s_max]
                if i16:
                    # exact for PCM16-origin samples: y·32768 lands on the
                    # stored integer
                    y = np.clip(np.round(y * 32768.0), -32768,
                                32767).astype(np.int16)
            pcm[row, : len(y)] = y
            lengths[row] = t
            # the true PCM length: the device front-end masks pre-emphasis
            # here, so padded batches match the emphasise-then-pad order
            sample_lengths[row] = min(len(y), s_max)
            names.append(utt.name)
        return {"names": names, "pcm": pcm, "feat_lengths": lengths,
                "sample_lengths": sample_lengths}

    def batches(self) -> Iterator[dict]:
        """Yields ``{names, pcm (B, S), feat_lengths (B,), sample_lengths
        (B,)}`` per bucket chunk: a header scan buckets the utterances, then
        prefetch threads decode batches on demand (memory stays O(batch))."""
        sized = list(ThreadedPrefetcher(self.utts, self._utt_samples,
                                        num_workers=self.num_workers))
        if self.transport == "auto":
            self._resolved_transport = (
                "int16" if sized and all(ok for _, _, ok in sized) else "float32")
        lengths = [num_frames(n, self.frame_len, self.frame_step)
                   for _, n, _ in sized]
        if self.n_buckets is not None:
            edges = np.asarray(optimal_bucket_edges(lengths, self.n_buckets), np.int64)
            tops = edges[np.searchsorted(edges, lengths, side="left")]
        else:
            tops = [-(-t // self.bucket_frames) * self.bucket_frames for t in lengths]
        items = [(utt, t, int(bt)) for (utt, _n, _ok), t, bt in zip(sized, lengths, tops)]
        items.sort(key=lambda it: (it[2], it[0].name))
        chunks: list[list] = []
        i = 0
        while i < len(items):
            bucket_t = items[i][2]
            chunk = [it for it in items[i: i + self.batch_size] if it[2] == bucket_t]
            i += len(chunk)
            chunks.append(chunk)
        yield from ThreadedPrefetcher(
            [(c,) for c in chunks], self._assemble, num_workers=self.num_workers,
            lookahead=4)
