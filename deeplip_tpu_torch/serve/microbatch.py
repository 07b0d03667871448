"""Dynamic micro-batching front-end for the serving surface.

Counterpart of ``deeplip_tpu/serve/microbatch.py``. Every decision call on a
:class:`SpeakerVerifier` costs one embedding pass: fine for a single
caller, wasteful under concurrent load, where each pass pays its own kernel
launches and copies for one row. :class:`MicroBatcher` is dynamic batching
as in TF-Serving or Triton: concurrent ``verify`` / ``identify`` / ``score``
/ ``enroll`` / ``embed`` callers enqueue their utterances; a collector
thread coalesces what arrives within ``max_wait_ms`` (or up to ``max_batch``
slots) into one bucketed extraction (:meth:`SpeakerVerifier.embed_pcm`, the
path batch-1 calls use), then finishes each request with the verifier's
scoring (``score_embedding`` / ``identify_embedding``). Batching changes
when an embedding is computed, never the function that computes it: VALID
convolutions, masked CMVN and masked pooling make a padded batch row the
batch-1 extraction of that row, to FP32 rounding: the GEMM and convolution
libraries may block or pick their algorithm by the batch size, on the CPU
and on the card alike.

Shape discipline:

- length: the extraction set is built with ``n_buckets: 0``, the fixed
  ``bucket_frames`` quantisation, so the batch shapes do not follow every
  micro-batch's own length histogram;
- rows: each length bucket's row count is padded up to the next power of
  two (``pad_rows=True``) by repeating one real utterance, so row counts
  come from {1, 2, 4, ..., max_batch}. Pad rows are dropped before scoring.

The collector thread launches kernels; it runs with the verifier's device
current, and hands numpy results to the futures only after the copy back
has waited for the device.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from deeplip_tpu_torch.data.audio_io import read_wav, resample
from deeplip_tpu_torch.ops.framing import frame_len_step, num_frames, samples_for_frames
from deeplip_tpu_torch.serve.verifier import SpeakerVerifier, VerifyResult, _l2


@dataclass
class _Request:
    kind: str                    # verify | identify | score | embed | enroll
    pcm: list[np.ndarray]        # one or more utterances (enroll may have several)
    args: tuple
    future: Future = field(default_factory=Future)


class MicroBatcher:
    """Coalesce concurrent serving requests into batched embedding passes.

    Args:
        verifier: the :class:`SpeakerVerifier` to serve. Its profile store,
            threshold and cohort are used as they are; direct calls on the
            verifier remain valid alongside the batcher.
        max_batch: flush when this many utterance slots are pending.
        max_wait_ms: flush this long after the first pending request even
            if the batch is not full: the latency the first arrival pays to
            let a batch form. 0 takes whatever is already queued.
        pad_rows: pad each length bucket's row count to the next power of
            two.

    Any number of client threads may call the public methods at once. Use
    as a context manager or call :meth:`close`.
    """

    def __init__(self, verifier: SpeakerVerifier, max_batch: int = 64,
                 max_wait_ms: float = 5.0, pad_rows: bool = True):
        self.verifier = verifier
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.pad_rows = bool(pad_rows)
        fc = verifier.extractor.feat_cfg
        self._rate = int(fc.rate)
        self._fl, self._fs = frame_len_step(fc.win_len, fc.win_shift, fc.rate)
        self._bucket_frames = int(dict(verifier.extractor.test_opts).get("bucket_frames", 100))
        self._q: queue.Queue[_Request | None] = queue.Queue()
        self._lock = threading.Lock()  # profile mutations (enroll)
        self.n_batches = 0
        self.n_requests = 0
        self.n_slots = 0             # utterance slots embedded (pads included)
        self.n_pad_slots = 0
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="deeplip-microbatcher")
        self._thread.start()

    # -- public API (blocking; safe from many threads) ---------------------
    def verify(self, speaker: str, pcm) -> VerifyResult:
        return self.submit_verify(speaker, pcm).result()

    def score(self, speaker: str, pcm) -> float:
        return self._submit("score", [pcm], (speaker,)).result()

    def identify(self, pcm, top_k: int = 1) -> list[tuple[str, float]]:
        return self._submit("identify", [pcm], (top_k,)).result()

    def embed(self, pcm) -> np.ndarray:
        return self._submit("embed", [pcm], ()).result()

    def enroll(self, speaker: str, items) -> np.ndarray:
        if self.verifier._is_single_item(items):
            items = [items]
        return self._submit("enroll", list(items), (speaker,)).result()

    def submit_verify(self, speaker: str, pcm) -> Future:
        """Non-blocking :meth:`verify`; resolve with ``Future.result()``."""
        return self._submit("verify", [pcm], (speaker,))

    def close(self) -> None:
        """Drain pending requests, then stop the collector thread."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        # a submit that raced close() may have enqueued after the sentinel:
        # fail it rather than leave its caller waiting
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.future.set_exception(RuntimeError("MicroBatcher is closed"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def mean_batch_slots(self) -> float:
        """Mean real (non-pad) utterance slots per embedding pass."""
        real = self.n_slots - self.n_pad_slots
        return real / self.n_batches if self.n_batches else 0.0

    # -- internals ---------------------------------------------------------
    def _submit(self, kind: str, pcm: Sequence, args: tuple) -> Future:
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        arrs = []
        for p in pcm:
            if isinstance(p, str):
                y, sr = read_wav(p)
                if sr != self._rate:
                    y = resample(y, sr, self._rate)
                arrs.append(np.asarray(y, np.float32))
            else:
                arrs.append(np.asarray(p, np.float32).reshape(-1))
        req = _Request(kind, arrs, args)
        self._q.put(req)
        return req.future

    def _loop(self) -> None:
        dev = self.verifier.extractor.device
        # the current device is per thread: streams and events made here
        # must belong to the verifier's card
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            while True:
                req = self._q.get()
                if req is None:
                    return
                batch = [req]
                slots = len(req.pcm)
                deadline = time.perf_counter() + self.max_wait
                while slots < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    try:
                        nxt = (self._q.get_nowait() if remaining <= 0
                               else self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                    if nxt is None:  # close(): flush this batch, then exit
                        self._flush(batch)
                        return
                    batch.append(nxt)
                    slots += len(nxt.pcm)
                self._flush(batch)

    def _bucket_top_samples(self, n: int) -> int:
        """The padded sample count ``n`` lands at under the serving set's
        fixed ``bucket_frames`` quantisation: a pad row must reuse a real
        bucket, so that it joins an existing chunk."""
        t = num_frames(n, self._fl, self._fs)
        t = -(-t // self._bucket_frames) * self._bucket_frames
        fc = self.verifier.extractor.feat_cfg
        return samples_for_frames(t, fc.win_len, fc.win_shift, self._rate)

    def _flush(self, batch: list[_Request]) -> None:
        table: dict[str, np.ndarray] = {}
        slot_names: list[list[str]] = []
        for i, req in enumerate(batch):
            names = []
            for j, y in enumerate(req.pcm):
                name = f"r{i}_{j}"
                table[name] = y
                names.append(name)
            slot_names.append(names)

        n_pads = 0
        if self.pad_rows and table:
            by_bucket: dict[int, list[str]] = {}
            for name, y in table.items():
                by_bucket.setdefault(self._bucket_top_samples(len(y)), []).append(name)
            for names in by_bucket.values():
                want = 1 << (len(names) - 1).bit_length()  # next power of two
                for _ in range(want - len(names)):
                    # repeat a real row (same length, same bucket): real PCM
                    # keeps the pad rows on the well-conditioned path
                    table[f"__pad{n_pads}"] = table[names[0]]
                    n_pads += 1

        try:
            store = self.verifier.embed_pcm(table, set_overrides={"n_buckets": 0})
            # one copy back for the whole batch; it waits for the device, so
            # what the futures receive is finished host memory
            real = [n for names in slot_names for n in names]
            host = dict(zip(real, store.matrix(real).cpu().numpy()))
        except Exception as e:  # the embedding failed: fail every waiting request
            for req in batch:
                req.future.set_exception(e)
            return
        self.n_batches += 1
        self.n_requests += len(batch)
        self.n_slots += len(table)
        self.n_pad_slots += n_pads

        for req, names in zip(batch, slot_names):
            try:
                req.future.set_result(self._finish(req, [host[n] for n in names]))
            except Exception as e:
                req.future.set_exception(e)

    def _finish(self, req: _Request, embs: list[np.ndarray]):
        v = self.verifier
        if req.kind == "verify":
            return v.verify_embedding(req.args[0], embs[0])
        if req.kind == "score":
            return v.score_embedding(req.args[0], embs[0])
        if req.kind == "identify":
            return v.identify_embedding(embs[0], top_k=req.args[0])
        if req.kind == "embed":
            return embs[0]
        if req.kind == "enroll":
            # ProfileVerifier.enroll's profile, on batch-extracted embeddings
            profile = _l2(np.mean([_l2(e.reshape(-1)) for e in embs], axis=0))
            with self._lock:
                v.profiles[req.args[0]] = profile
            return profile
        raise ValueError(f"unknown request kind {req.kind!r}")
