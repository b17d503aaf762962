"""Prefetching host feed (port of ``repro.data.pipeline.PrefetchingLoader``).

Wraps ``batch_fn(step) -> batch`` with N-deep background prefetch on
``n_producers`` threads sharing one bounded queue.  Producer t generates
steps ``start_step + t, start_step + t + n_producers, ...``, so the step
stream is covered exactly once; items may interleave across producers, so
consumers key on the step id each item carries.  Error semantics are
drain-then-raise: the FIRST producer error stops every producer, batches
already queued drain normally, then the error surfaces on ``__next__``.
Batches pass through as the producer made them (host arrays); the consumer
moves them to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional


class PrefetchingLoader:
    def __init__(self, batch_fn: Callable[[int], Any], prefetch: int = 2,
                 start_step: int = 0, n_producers: int = 1):
        self.batch_fn = batch_fn
        self.prefetch = max(1, prefetch)
        self.n_producers = max(1, n_producers)
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._work, args=(start_step + t,),
                             daemon=True)
            for t in range(self.n_producers)]
        for t in self._threads:
            t.start()

    def _work(self, step: int):
        try:
            while not self._stop.is_set():
                item = (step, self.batch_fn(step))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += self.n_producers
        except BaseException as e:  # surfaced on next __next__
            with self._err_lock:
                if self._err is None:
                    self._err = e
            # one dead producer poisons the stream: stop the others so the
            # queue drains to empty and the error actually surfaces
            self._stop.set()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        # poll with a timeout and re-check the producers each lap: a plain
        # blocking get() would hang forever when a producer dies with the
        # queue empty
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._err is not None:
                    raise self._err
                if not any(t.is_alive() for t in self._threads):
                    raise StopIteration

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
