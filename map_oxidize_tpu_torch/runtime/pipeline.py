"""Bounded-prefetch streaming pipeline: overlap host production with
device dispatch.

    producer thread:  read + tokenize chunk i+1 .. i+depth   (the C++ scan
                      releases the GIL for its hot part)
    consumer thread:  copy to the device + fold chunk i

:class:`ChunkPrefetcher` wraps ANY iterator with a depth-``N`` bounded
queue (the backpressure bound: at most ``depth`` chunks of host memory in
flight) and measures the overlap it achieved:

* ``produce_s`` — host time spent producing items (the work to hide);
* ``wait_s``    — consumer time spent stalled for the next item (the part
  of ``produce_s`` that was NOT hidden);
* ``overlap_ratio`` — ``1 - wait_s / produce_s``.

Ordering is the queue's FIFO, i.e. identical to the serial iteration, so
outputs — including checkpoint spill order and kill-resume replay — are
byte-identical to ``depth=1``.  Exceptions (BaseException included: the
kill-resume contract is a ``KeyboardInterrupt`` mid-map) propagate to the
consumer after the items produced before them, exactly like serial
iteration.

``pipelined()`` is the driver-facing wrapper: depth <= 1 returns the
iterator untouched (the serial schedule, no thread), and with an ``Obs``
bundle it records the live ``pipeline/*`` counters and gauges.

:class:`BlockStager` is the prefetcher as a device stager: its producer
runs the caller's ``stage_fn`` over pre-grouped blocks (:func:`chunk_groups`),
which fills a :class:`StagingRing` slot and issues the block's
host-to-device copy, so staging and transferring block i+1 overlap the
device's work on block i.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_DONE = object()


def overlap_ratio(produce_s: float, wait_s: float) -> float:
    """Fraction of host produce time hidden behind consumer work: 1.0 means
    every produce second ran behind the consumer, 0.0 the serial
    schedule."""
    if produce_s <= 0.0:
        return 1.0
    return max(0.0, 1.0 - wait_s / produce_s)


class ChunkPrefetcher:
    """Depth-bounded background producer over any iterator.

    The producer thread starts lazily on first ``__iter__`` and dies with
    the stream: exhaustion, a producer error, or the consumer abandoning
    the iteration (generator close / driver abort) all stop it — the
    abandon path sets a stop flag and drains the queue so a producer
    blocked on ``put`` wakes and exits instead of pinning ``depth``
    chunks of host memory until process end.

    With an ``obs`` bundle (the JAX package's ``runtime/pipeline.py:182-187``
    and ``:294-318``), every consumed item flushes the produce/wait deltas
    into the live counters ``pipeline/produce_ms``, ``pipeline/feed_wait_ms``
    and ``pipeline/chunks``, and a traced run records the handoff spans
    ``<name>/produce`` (producer thread) and ``<name>/feed_wait``
    (consumer), paired by ``seq``.  The producer thread runs under the
    spawning job's context binding (``obs.context.bind_current``).
    """

    def __init__(self, it: Iterable[T], depth: int, name: str = "pipeline",
                 obs=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        from map_oxidize_tpu_torch.obs.context import bind_current

        self._it = iter(it)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._name = name
        self._stop = False
        self._err: BaseException | None = None
        self._obs = obs
        self._reported_produce = 0.0
        self._reported_wait = 0.0
        self._thread = threading.Thread(
            target=bind_current(self._produce), daemon=True,
            name=f"{name}-prefetch")
        #: host time spent producing items
        self.produce_s = 0.0
        #: consumer time spent stalled waiting for the next item
        self.wait_s = 0.0
        #: items handed to the consumer
        self.items = 0

    # --- producer ---------------------------------------------------------

    def _produce(self) -> None:
        tracer = self._obs.tracer if self._obs is not None else None
        seq = 0
        try:
            while not self._stop:
                t0 = time.perf_counter()
                # the producer half of the handoff, paired by seq with the
                # consumer's feed_wait span; exhaustion takes the sentinel
                # default so no StopIteration crosses the span
                if tracer is not None and tracer.enabled:
                    with tracer.span(f"{self._name}/produce",
                                     seq=seq) as sp:
                        item = next(self._it, _DONE)
                        if item is _DONE:
                            sp.set(exhausted=True)
                else:
                    item = next(self._it, _DONE)
                if item is _DONE:
                    return
                seq += 1
                self.produce_s += time.perf_counter() - t0
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

    @property
    def overlap_ratio(self) -> float:
        return overlap_ratio(self.produce_s, self.wait_s)

    def _flush_counters(self, chunks: int = 0) -> None:
        """Report the produce/wait accumulated since the last flush into
        the job registry.  ``produce_s`` is written by the producer thread;
        a torn read only shifts a delta to the next flush."""
        if self._obs is None:
            return
        reg = self._obs.registry
        dp = self.produce_s - self._reported_produce
        dw = self.wait_s - self._reported_wait
        if dp > 0:
            self._reported_produce += dp
            reg.count("pipeline/produce_ms", dp * 1e3)
        if dw > 0:
            self._reported_wait += dw
            reg.count("pipeline/feed_wait_ms", dw * 1e3)
        if chunks:
            reg.count("pipeline/chunks", chunks)

    def __iter__(self) -> Iterator[T]:
        self._thread.start()
        tracer = self._obs.tracer if self._obs is not None else None
        seq = 0
        try:
            while True:
                t0 = time.perf_counter()
                if tracer is not None and tracer.enabled:
                    # the consumer half of the handoff: the span's wall is
                    # the stall waiting for item seq
                    with tracer.span(f"{self._name}/feed_wait", seq=seq):
                        item = self._q.get()
                else:
                    item = self._q.get()
                seq += 1
                self.wait_s += time.perf_counter() - t0
                if item is _DONE:
                    if self._err is not None:
                        raise self._err
                    return
                self.items += 1
                self._flush_counters(chunks=1)
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
            self._flush_counters()


def pipelined(it: Iterable[T], depth: int, obs=None,
              name: str = "pipeline",
              ratio_gauge: str | None = None) -> Iterable[T]:
    """Prefetch ``it`` with ``depth - 1`` items queued ahead of the one the
    consumer holds, recording into ``obs`` when given: the prefetcher's
    live counters, the ``pipeline/overlap_ratio`` gauge after every item
    and, when the stream ends, the ``pipeline/depth`` gauge and a
    ``<name>/pipeline_done`` trace instant.  ``depth <= 1`` returns ``it``
    unchanged — the serial schedule, no thread, no counters — so
    ``--pipeline-depth 1`` is a true control arm, not a degenerate
    pipeline.  ``ratio_gauge`` names an extra gauge fed the same overlap
    ratio (the push cadence passes ``pipeline/shuffle_overlap_ratio``;
    JAX ``runtime/pipeline.py:278``)."""
    if depth <= 1:
        return it
    pf = ChunkPrefetcher(it, depth - 1, name=name, obs=obs)
    if obs is None:
        return iter(pf)

    def _set_ratio(reg) -> None:
        ratio = round(pf.overlap_ratio, 4)
        reg.set("pipeline/overlap_ratio", ratio)
        if ratio_gauge:
            reg.set(ratio_gauge, ratio)

    def _run():
        reg = obs.registry
        try:
            for item in pf:
                _set_ratio(reg)
                yield item
        finally:
            if pf.items or pf.produce_s:
                reg.set("pipeline/depth", depth)
                _set_ratio(reg)
                obs.tracer.instant(
                    f"{name}/pipeline_done", items=pf.items,
                    produce_ms=round(pf.produce_s * 1e3, 3),
                    wait_ms=round(pf.wait_s * 1e3, 3),
                    overlap_ratio=round(pf.overlap_ratio, 4))

    return _run()


def chunk_groups(items: Iterable, batch: int) -> list:
    """Group ``items`` into lists of at most ``batch`` (the last group may
    be short): the block layout :func:`staged_blocks` and
    :class:`BlockStager` consume."""
    if batch < 1:
        raise ValueError(f"dispatch batch must be >= 1, got {batch}")
    items = list(items)
    return [items[i:i + batch] for i in range(0, len(items), batch)]


def staged_blocks(groups: Iterable, stage_fn):
    """Serial staging: yields ``stage_fn(group)`` for each group (the
    ``depth <= 1`` control arm of :class:`BlockStager`, and its producer
    body)."""
    for group in groups:
        yield stage_fn(group)


class BlockStager(ChunkPrefetcher):
    """Runs ``stage_fn(group)`` for each pre-built group in the producer
    thread, so staging (and the host-to-device copy it issues) of block
    i+1 overlaps the consumer's work on block i.  The group sequence may
    span the iterations of a multi-pass consumer: data blocks do not
    depend on the consumer's evolving state, so iteration i+1's first
    block stages while iteration i's last block computes.

    ``stage_fn`` must not refill memory that a block in flight still
    reads (the CUDA form of the JAX package's ownership handoff at the
    put): :class:`StagingRing` guards its slots with events.
    ``produce_s`` measures staging per block, ``wait_s`` the consumer's
    stalls; with ``obs`` both feed the live ``pipeline/*`` counters per
    block."""

    def __init__(self, groups: Iterable, stage_fn, depth: int = 1,
                 name: str = "stager", obs=None):
        super().__init__(staged_blocks(groups, stage_fn), depth, name=name,
                         obs=obs)


class StagingRing:
    """A fixed ring of ``slots`` staging blocks of ``rows`` x ``d`` points
    of ``dtype``, for a producer (:meth:`stage`) and a consumer
    (:meth:`acquire` / :meth:`release`) in one or two threads.

    On a CUDA device each slot is a pinned host buffer and a device block.
    :meth:`stage` fills the pinned buffer from a host array (cast to
    ``dtype``, round to nearest even for bf16) and copies it to the device
    block on a copy stream, recording the slot's ``copied`` event;
    :meth:`acquire` makes the consumer's current stream wait on that event;
    :meth:`release` records the slot's ``released`` event on the current
    stream after the launches that read the block.  Before refilling a
    slot, :meth:`stage` waits on the host for its ``released`` event, so
    neither the pinned buffer nor the device block is overwritten while a
    copy or a kernel still reads it.  A fixed ring also keeps the caching
    allocator out of frees across streams.  A pinned buffer refilled from
    pageable memory is what makes the copy asynchronous: a
    ``non_blocking`` copy from pageable memory runs synchronously.

    On the CPU a slot is one host tensor, which is also the block: no
    pinned memory, no streams, no copy.

    Blocks stage in sequence order, block ``seq`` into slot ``seq %
    slots``; with a producer at most ``slots - 2`` blocks ahead of the
    consumer (a :class:`BlockStager` of depth ``slots - 2``, or serial
    staging with ``slots >= 2``), block ``seq - slots`` was released before
    block ``seq`` stages.  :meth:`stage` checks that and raises if not."""

    def __init__(self, slots: int, rows: int, d: int, dtype: torch.dtype,
                 device: torch.device):
        self.slots = slots
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        shape = (rows, d)
        self._host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                      for _ in range(slots)]
        # bf16 has no NumPy dtype: fill an f32 buffer, then cast in torch
        self._f32 = (np.empty(shape, np.float32) if dtype != torch.float32
                     else None)
        self._released_seq = [-1] * slots
        if self.cuda:
            self._dev = [torch.empty(shape, dtype=dtype, device=self.device)
                         for _ in range(slots)]
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(slots)]
            self._released = [torch.cuda.Event() for _ in range(slots)]
        else:
            self._dev = self._host

    def stage(self, seq: int, src: np.ndarray) -> int:
        """Fill slot ``seq % slots`` with the rows of ``src`` and, on CUDA,
        start their copy to the device.  Returns the slot."""
        return self.stage_parts(seq, [src])

    def stage_parts(self, seq: int, parts) -> int:
        """:meth:`stage` of the rows of several host arrays, one after
        another (a shard's slices of the chunks of a block)."""
        slot = seq % self.slots
        if seq >= self.slots and self._released_seq[slot] != seq - self.slots:
            raise RuntimeError(
                f"staging ring overrun: block {seq} would refill slot {slot} "
                f"before block {seq - self.slots} was released")
        if self.cuda:
            self._released[slot].synchronize()
        host = self._host[slot]
        fill = host.numpy() if self._f32 is None else self._f32
        m = 0
        for src in parts:
            np.copyto(fill[m:m + src.shape[0]], src)
            m += src.shape[0]
        if self._f32 is not None:
            host[:m].copy_(torch.from_numpy(self._f32[:m]))
        if self.cuda:
            with torch.cuda.stream(self._copy_stream):
                self._dev[slot][:m].copy_(host[:m], non_blocking=True)
                self._copied[slot].record(self._copy_stream)
        return slot

    def acquire(self, slot: int) -> torch.Tensor:
        """The slot's block, ordered after its copy on the current stream."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[slot])
        return self._dev[slot]

    def release(self, slot: int, seq: int) -> None:
        """The launches that read block ``seq`` in ``slot`` are issued; the
        slot may be refilled once they finish."""
        if self.cuda:
            self._released[slot].record(torch.cuda.current_stream(self.device))
        self._released_seq[slot] = seq
