"""Opened-corpus cache with idle eviction: a copy of the JAX package's
``serve/corpus.py`` (``CorpusCache`` :48).

A resident server's repeated small jobs hit the same corpora; each
driver still streams by path, but keeping the file OPEN between jobs
(a retained fd + an mmap of the first pages) keeps the kernel page cache
warm and makes re-submission validation (exists, size, readable) a dict
probe instead of filesystem calls.  Entries are evicted after
``idle_evict_s`` without a touching job — the knob for hosts where a
long-idle server must not pin page cache (``--idle-evict-s``).

The cache stores no corpus BYTES of its own (the drivers mmap/stream on
their own); eviction therefore never invalidates a running job — it only
drops the warmth.
"""

from __future__ import annotations

import mmap
import os
import threading
import time

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


class _Entry:
    __slots__ = ("path", "size", "f", "mm", "last_used", "opened_at",
                 "hits")

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.size = os.fstat(self.f.fileno()).st_size
        # a zero-length mmap is invalid; empty corpora keep just the fd
        self.mm = (mmap.mmap(self.f.fileno(), 0, access=mmap.ACCESS_READ)
                   if self.size else None)
        self.opened_at = self.last_used = time.monotonic()
        self.hits = 0

    def close(self) -> None:
        if self.mm is not None:
            self.mm.close()
        self.f.close()


class CorpusCache:
    """Path-keyed open-file cache.  Internally locked, so the scheduler
    can open corpora at submit time WITHOUT holding its own condition
    lock (a stalled filesystem then blocks only that one submission, not
    the whole job plane); the lock order is always scheduler -> cache,
    never the reverse."""

    def __init__(self, idle_evict_s: float = 300.0, clock=time.monotonic):
        self.idle_evict_s = idle_evict_s
        self._clock = clock
        self._mu = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self.evictions = 0

    def open(self, path: str) -> int:
        """Open (or touch) ``path``; returns its size.  Raises ``OSError``
        for missing/unreadable inputs — the submit-time check that turns
        a would-be mid-run abort into a named rejection."""
        path = os.path.abspath(path)
        with self._mu:
            e = self._entries.get(path)
            if e is not None:
                e.last_used = self._clock()
                e.hits += 1
                return e.size
        # the blocking open/fstat/mmap happens OUTSIDE the mutex: a
        # stalled filesystem must block only this caller, never the
        # touch/evict paths the scheduler drives under its own lock
        fresh = _Entry(path)
        with self._mu:
            e = self._entries.get(path)
            if e is None:
                e = self._entries[path] = fresh
                _log.debug("[serve] corpus opened: %s (%d bytes)",
                           path, e.size)
            else:                     # lost a concurrent-open race
                fresh.close()
            e.last_used = self._clock()
            e.hits += 1
            return e.size

    def touch(self, path: str) -> None:
        with self._mu:
            e = self._entries.get(os.path.abspath(path))
            if e is not None:
                e.last_used = self._clock()

    def evict_idle(self) -> int:
        """Close entries idle past the TTL; returns how many."""
        if self.idle_evict_s <= 0:
            return 0
        with self._mu:
            now = self._clock()
            idle = [p for p, e in self._entries.items()
                    if now - e.last_used > self.idle_evict_s]
            for p in idle:
                self._entries.pop(p).close()
                self.evictions += 1
                _log.debug("[serve] corpus evicted after idle: %s", p)
            return len(idle)

    def close_all(self) -> None:
        with self._mu:
            for e in self._entries.values():
                e.close()
            self._entries.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def __contains__(self, path: str) -> bool:
        with self._mu:
            return os.path.abspath(path) in self._entries

    def doc(self) -> list[dict]:
        with self._mu:
            now = self._clock()
            return [{"path": e.path, "bytes": e.size, "hits": e.hits,
                     "idle_s": round(now - e.last_used, 3)}
                    for e in sorted(self._entries.values(),
                                    key=lambda e: e.path)]
