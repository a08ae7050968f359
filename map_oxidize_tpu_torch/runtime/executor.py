"""Host map executor: the worker-pool phase engine.

A bounded ThreadPoolExecutor over a *lazy* chunk stream:

* chunks are claimed from an iterator, so the corpus is never fully
  resident;
* bounded in-flight submissions backpressure the reader against the device;
* failed chunks are retried ``max_retries`` times before aborting the job.

Python threads are the right tool here because the hot loop either runs in
C++ with the GIL released (ctypes) or in C-speed CPython builtins
(bytes.split/Counter); the host side only has to keep up with feeding the
device.
"""

from __future__ import annotations

import os
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Iterable, Iterator

from map_oxidize_tpu_torch.api import Mapper, MapOutput
from map_oxidize_tpu_torch.obs.context import bind_current
from map_oxidize_tpu_torch.runtime.pipeline import pipelined
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


class MapTaskError(RuntimeError):
    """A chunk failed all retry attempts."""


def _attempt(mapper: Mapper, chunk: bytes, index: int,
             max_retries: int) -> MapOutput:
    for attempt in range(max_retries + 1):
        try:
            return mapper.map_chunk(chunk)
        except Exception as e:  # noqa: BLE001 — retry any mapper failure
            if attempt == max_retries:
                raise MapTaskError(
                    f"map task for chunk {index} failed after "
                    f"{max_retries + 1} attempts: {e}"
                ) from e
            _log.warning("map chunk %d attempt %d failed: %s; retrying",
                         index, attempt + 1, e)
    raise AssertionError("unreachable")


def run_map_phase(
    chunks: Iterable[bytes],
    mapper: Mapper,
    num_workers: int,
    max_retries: int = 2,
    pipeline_depth: int = 1,
    obs=None,
) -> Iterator[tuple[int, MapOutput]]:
    """Map chunks concurrently; yield ``(chunk_index, MapOutput)`` in
    completion order.  At most ``2 * num_workers`` chunks are in flight, which
    bounds host memory and backpressures the input reader.

    With one worker (or one host core — where extra threads only add
    scheduler churn) the pool is skipped and chunks map inline — in a
    :mod:`~map_oxidize_tpu_torch.runtime.pipeline` prefetch thread when
    ``pipeline_depth > 1``, so chunk i+1's read+tokenize overlaps chunk
    i's engine feed in the caller.  With the pool active, the pool already
    overlaps mapping; the pipeline instead read-aheads the *chunk input*
    by ``pipeline_depth`` so the submit loop never stalls on I/O.  ``obs``
    records the pipeline's counters, and the pool's tasks run under the
    submitting job's context binding."""
    if num_workers <= 1 or (os.cpu_count() or 1) <= 1:
        def _inline():
            for idx, chunk in enumerate(chunks):
                yield idx, _attempt(mapper, chunk, idx, max_retries)
        yield from pipelined(_inline(), pipeline_depth, obs, name="map")
        return
    chunks = pipelined(chunks, pipeline_depth, obs, name="read")
    attempt = bind_current(_attempt)
    max_inflight = max(2, 2 * num_workers)
    with ThreadPoolExecutor(max_workers=num_workers,
                            thread_name_prefix="map") as pool:
        inflight: dict[Future, int] = {}
        it = enumerate(chunks)
        exhausted = False
        while True:
            while not exhausted and len(inflight) < max_inflight:
                try:
                    idx, chunk = next(it)
                except StopIteration:
                    exhausted = True
                    break
                inflight[pool.submit(attempt, mapper, chunk, idx,
                                     max_retries)] = idx
            if not inflight:
                return
            done, _ = wait(inflight, return_when=FIRST_COMPLETED)
            for fut in done:
                idx = inflight.pop(fut)
                yield idx, fut.result()  # re-raises MapTaskError
