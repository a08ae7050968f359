"""Bounded-prefetch streaming pipeline: overlap host production with
device dispatch.

    producer thread:  read + tokenize chunk i+1 .. i+depth   (the C++ scan
                      releases the GIL for its hot part)
    consumer thread:  copy to the device + fold chunk i

:class:`ChunkPrefetcher` wraps ANY iterator with a depth-``N`` bounded
queue (the backpressure bound: at most ``depth`` chunks of host memory in
flight).

Ordering is the queue's FIFO, i.e. identical to the serial iteration, so
outputs — including checkpoint spill order and kill-resume replay — are
byte-identical to ``depth=1``.  Exceptions (BaseException included: the
kill-resume contract is a ``KeyboardInterrupt`` mid-map) propagate to the
consumer after the items produced before them, exactly like serial
iteration.

``pipelined()`` is the driver-facing wrapper: depth <= 1 returns the
iterator untouched (the serial schedule, no thread).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class ChunkPrefetcher:
    """Depth-bounded background producer over any iterator.

    The producer thread starts lazily on first ``__iter__`` and dies with
    the stream: exhaustion, a producer error, or the consumer abandoning
    the iteration (generator close / driver abort) all stop it — the
    abandon path sets a stop flag and drains the queue so a producer
    blocked on ``put`` wakes and exits instead of pinning ``depth``
    chunks of host memory until process end.
    """

    def __init__(self, it: Iterable[T], depth: int, name: str = "pipeline"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(it)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name=f"{name}-prefetch")

    # --- producer ---------------------------------------------------------

    def _produce(self) -> None:
        try:
            while not self._stop:
                item = next(self._it, _DONE)
                if item is _DONE:
                    return
                # timed put loop instead of a blocking put: an abandoned
                # consumer only drains once, so a producer stuck in a
                # plain put() could miss the wakeup and leak its chunk
                while not self._stop:
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — hand EVERYTHING to the
            # consumer: a KeyboardInterrupt raised by a mapper mid-chunk is
            # the kill-resume contract, not an exit signal for this thread
            self._err = e
        finally:
            while not self._stop:
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # --- consumer ---------------------------------------------------------

    def __iter__(self) -> Iterator[T]:
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is _DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            # abandon/exhaustion: release the producer if it is still
            # blocked, then let the daemon thread unwind
            self._stop = True
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass


def pipelined(it: Iterable[T], depth: int,
              name: str = "pipeline") -> Iterable[T]:
    """Prefetch ``it`` with ``depth - 1`` items queued ahead of the one the
    consumer holds.  ``depth <= 1`` returns ``it`` unchanged — the serial
    schedule, no thread — so ``--pipeline-depth 1`` is a true control
    arm, not a degenerate pipeline."""
    if depth <= 1:
        return it
    return iter(ChunkPrefetcher(it, depth - 1, name=name))
