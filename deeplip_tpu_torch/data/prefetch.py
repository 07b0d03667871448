"""Host-side prefetching: overlap wav IO and batch assembly with device work.

Counterpart of ``deeplip_tpu/data/prefetch.py: ThreadedPrefetcher``. The
host only decodes and pads PCM (the DSP runs on the device), so a small
thread pool with a bounded lookahead keeps the card fed.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


class ThreadedPrefetcher:
    """Run ``producer(item)`` for items of ``schedule`` in worker threads,
    yielding results in schedule order with a bounded lookahead. A tuple item
    is unpacked into the producer's arguments."""

    def __init__(
        self,
        schedule: Iterable,
        producer: Callable[..., T],
        num_workers: int = 4,
        lookahead: int = 8,
    ):
        self.schedule = list(schedule)
        self.producer = producer
        self.num_workers = max(1, num_workers)
        self.lookahead = max(1, lookahead)

    def __iter__(self) -> Iterator[T]:
        results: dict[int, T] = {}
        lock = threading.Condition()
        next_job = [0]
        emit_idx = [0]
        errors: list[BaseException] = []
        n = len(self.schedule)

        def worker():
            while True:
                with lock:
                    # bound how far ahead of the consumer the workers run
                    while (next_job[0] < n
                           and next_job[0] - emit_idx[0] >= self.lookahead
                           and not errors):
                        lock.wait(0.05)
                    if next_job[0] >= n or errors:
                        return
                    job = next_job[0]
                    next_job[0] += 1
                item = self.schedule[job]
                try:
                    out = (self.producer(*item) if isinstance(item, tuple)
                           else self.producer(item))
                except BaseException as e:  # handed to the consumer, re-raised there
                    with lock:
                        errors.append(e)
                        lock.notify_all()
                    return
                with lock:
                    results[job] = out
                    lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with lock:
                    while i not in results and not errors:
                        lock.wait(0.1)
                    if errors:
                        raise errors[0]
                    out = results.pop(i)
                    emit_idx[0] = i + 1
                    lock.notify_all()
                yield out
        finally:
            with lock:
                errors.append(StopIteration())  # tells the workers to exit
                lock.notify_all()
            for t in threads:
                t.join(timeout=1.0)
