"""k-means: the device-resident fit, the fit streamed through the device,
and the host-assign stream.

MapReduce formulation, as in the JAX package:

    map:    point -> (nearest centroid id, [x_0..x_{d-1}, 1])
    reduce: per-key vector sum
    emit:   new centroid c_k = sum_k[:d] / sum_k[d]

Three fits, one per ``kmeans_mode`` of the driver:

* :func:`kmeans_fit_device` (``device``) puts the points on the device ONCE
  and runs every iteration there;
* :func:`kmeans_fit_streamed_device` (``stream_device``) streams the points
  through the device in fixed-row chunks every iteration, for point sets
  beyond the device fit;
* :class:`KMeansMapper` + :func:`kmeans_iteration` (``stream``) assign on
  the host with NumPy and fold the per-chunk partial sums as ``(d+1,)`` f32
  values in the device reduce engine.

The device fits call the fused assign + sum
(:func:`~map_oxidize_tpu_torch.ops.kmeans_kernel.fused_assign_sum`: the
hand-written CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor) and a centroid update on the device.  Input convention: a ``.npy``
file of float32 ``(n, d)`` points, memory-mapped and read by row ranges.
"""

from __future__ import annotations

import mmap
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from map_oxidize_tpu_torch.api import Mapper, MapOutput, SumReducer
from map_oxidize_tpu_torch.obs import NULL_SPAN, observe_device_wait
from map_oxidize_tpu_torch.obs.compile import assign_sum_ops, observed
from map_oxidize_tpu_torch.obs.context import current_obs
from map_oxidize_tpu_torch.ops.kmeans_kernel import (
    calls_on_this_thread,
    fused_assign_sum,
    fused_assign_sum_plain as assign_and_sum,
    plan,
)

__all__ = ["KMeansMapper", "assign_and_sum", "assign_points",
           "iter_point_chunks", "kmeans_fit_device",
           "kmeans_fit_streamed_device", "kmeans_iteration", "kmeans_model",
           "make_kmeans", "write_centroids"]


def assign_points(points: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid ids, vectorized: argmin_k ||p||^2 - 2 p.C^T + ||c||^2
    (the ||p||^2 term is constant per point and dropped)."""
    d2 = -2.0 * points @ centroids.T + (centroids * centroids).sum(1)
    return np.argmin(d2, axis=1).astype(np.int32)


class KMeansMapper(Mapper):
    """Chunk of points -> per-centroid partial ``[sum_x..., count]`` rows
    (keys ``hi = 0, lo = centroid id``, no dictionary)."""

    value_dtype = np.float32
    keys_have_dictionary = False

    def __init__(self, centroids: np.ndarray):
        self.centroids = np.asarray(centroids, np.float32)
        self.k, self.d = self.centroids.shape
        self.value_shape = (self.d + 1,)

    def map_chunk(self, points) -> MapOutput:
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        if n == 0:
            return MapOutput(hi=np.empty(0, np.uint32),
                             lo=np.empty(0, np.uint32),
                             values=np.empty((0, self.d + 1), np.float32),
                             records_in=0)
        cid = assign_points(points, self.centroids)
        # per-chunk combine: one row per non-empty centroid (a bincount per
        # dimension is O(n*d) with no Python work per point)
        sums = np.empty((self.k, self.d + 1), np.float32)
        for j in range(self.d):
            sums[:, j] = np.bincount(cid, weights=points[:, j],
                                     minlength=self.k)
        counts = np.bincount(cid, minlength=self.k)
        sums[:, self.d] = counts
        live = counts > 0
        ids = np.nonzero(live)[0].astype(np.uint32)
        return MapOutput(hi=np.zeros(ids.shape[0], np.uint32), lo=ids,
                         values=sums[live], records_in=n)


def iter_point_chunks(path: str, rows_per_chunk: int):
    """Stream ``(n, d)`` float32 rows from a .npy file without loading it
    (``np.load`` memory-maps; slices fault in lazily)."""
    pts = np.load(path, mmap_mode="r")
    for start in range(0, pts.shape[0], rows_per_chunk):
        yield np.asarray(pts[start:start + rows_per_chunk], np.float32)


def kmeans_iteration(engine, centroids: np.ndarray, chunks,
                     mapper: "KMeansMapper | None" = None,
                     mapped=None) -> np.ndarray:
    """One host-assign iteration: feed every chunk's partial sums through
    the engine, reduce on the device, return the updated centroids.  An
    empty centroid keeps its position.

    ``mapped`` (an iterable of MapOutputs) replaces the chunk + map loop
    when the caller runs the host assign elsewhere (the driver passes a
    prefetch-pipelined map stream)."""
    centroids = np.asarray(centroids, np.float32)
    if mapped is None:
        if mapper is None:
            mapper = KMeansMapper(centroids)
        mapped = (mapper.map_chunk(chunk) for chunk in chunks)
    n_points = 0
    for out in mapped:
        n_points += out.records_in
        engine.feed(out)
    hi, lo, vals, _n = engine.finalize()
    live = ~(hi == np.uint32(0xFFFFFFFF))  # the SENTINEL hi plane pads
    ids = lo[live].astype(np.int64)
    sums = vals[live]
    new = centroids.copy()
    counts = sums[:, -1]
    # conservation: every point lands in exactly one centroid's count.
    # Counts fold as f32, which rounds once a cluster passes 2^24 points,
    # so the check has a tolerance
    total = float(np.asarray(counts, np.float64).sum())
    if n_points and abs(total - n_points) > max(1.0, 1e-4 * n_points):
        raise RuntimeError(
            f"k-means conservation violated: {n_points} points in, "
            f"{total} counted")
    nz = counts > 0
    new[ids[nz]] = sums[nz, :-1] / counts[nz, None]
    return new


def make_kmeans(centroids: np.ndarray):
    """(mapper, reducer) pair of the host-assign k-means."""
    return KMeansMapper(centroids), SumReducer()


def kmeans_model(points: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """NumPy oracle: one full-batch iteration (independent of the engine)."""
    points = np.asarray(points, np.float32)
    centroids = np.asarray(centroids, np.float32)
    cid = assign_points(points, centroids)
    new = centroids.copy()
    for k in range(centroids.shape[0]):
        m = cid == k
        if m.any():
            new[k] = points[m].mean(0)
    return new


def _kmeans_step_impl(c, p, k: int, precision: str = "highest"):
    """One iteration: assign + sum, then move every non-empty centroid to
    its mean (an empty centroid keeps its position)."""
    sums, counts = fused_assign_sum(p, c, k, precision)
    return torch.where(counts[:, None] > 0,
                       sums / counts.clamp_min(1.0)[:, None], c)


#: one iteration and the whole fit under the launch ledger (JAX
#: ``workloads/kmeans.py:279-287``): the fit is one dispatch of every
#: iteration, the step one dispatch of one
_kmeans_step = observed("kmeans/step", _kmeans_step_impl)


@observed("kmeans/fit")
def _kmeans_fit(c, p, k: int, iters: int, precision: str = "highest"):
    for _ in range(iters):
        c = _kmeans_step_impl(c, p, k, precision)
    return c


def kmeans_fit_device(points, centroids, iters: int = 1, device=None,
                      on_iter=None, timings: dict | None = None,
                      precision: str = "highest") -> np.ndarray:
    """Device-resident k-means: the points transfer once, ``iters``
    iterations run on ``device``, and the final centroids return as NumPy.

    In ``bf16`` mode the points are stored as bf16 on the device: every
    iteration re-reads the whole array and the score product rounds them to
    bf16 anyway, so the numerics are unchanged and the bytes halve.

    ``on_iter(i, centroids_np)`` sees the state after each iteration (one
    ``(k, d)`` fetch per iteration).  ``timings`` (when a dict is passed)
    receives ``transfer_s`` (the points from the caller's array to the
    device, :func:`_resident_points`: the host read, the bf16 rounding and
    the copy, as the JAX package's ``device_put`` of the map reads it) and
    ``iter_s`` (the whole iteration chain, synchronised, ``on_iter``'s
    calls included).  Inside a job, the transfer's two steps are also the
    counters ``kmeans/read_points_ms`` (the block loop: the reads, the bf16
    rounding, the copy launches and the slot waits) and
    ``kmeans/copy_points_ms`` (the drain of the copies and the sync), and
    spans of the same names when the job is traced; the counter
    ``kmeans/read_blocks`` counts the blocks read straight from the file;
    and each blocking centroid fetch (the per-iteration one for ``on_iter``
    and the final one, which waits for the whole iteration chain) is timed
    into its ``device/compute_ms``.  A job also counts the fused assign +
    sum's calls in ``kmeans/assign_sum_calls`` and, on a CUDA device,
    records the kernel's launch plan as the gauges ``kmeans/plan_grid``,
    ``kmeans/plan_resident``, ``kmeans/plan_acc_in_smem`` and
    ``kmeans/plan_k_pad`` (the centroid rows scored per point), read once
    from the cached plan."""
    if device is None:
        from map_oxidize_tpu_torch.runtime.engine import pick_device

        device = pick_device("cuda")
    device = torch.device(device)
    c = torch.from_numpy(np.array(centroids, np.float32)).to(device)
    k = c.shape[0]

    obs = current_obs()
    t0 = time.perf_counter()
    p, blocks = _resident_points(
        points, device, torch.bfloat16 if precision == "bf16" else
        torch.float32, obs.step if obs is not None else _no_step)
    if timings is not None:
        timings["transfer_s"] = time.perf_counter() - t0
    if obs is not None:
        obs.registry.count("kmeans/read_blocks", blocks)
        if device.type == "cuda":
            _record_plan(obs.registry, p, k, precision)
    calls = calls_on_this_thread()
    t0 = time.perf_counter()
    if on_iter is None:
        c = _kmeans_fit(c, p, k, iters, precision)
    else:
        for i in range(iters):
            c = _kmeans_step(c, p, k, precision)
            on_iter(i + 1, _fetch(c))
    out = _fetch(c)
    if timings is not None:
        timings["iter_s"] = time.perf_counter() - t0
    if obs is not None:
        obs.registry.count("kmeans/assign_sum_calls",
                           calls_on_this_thread() - calls)
    return out


#: the resident points go to the device in blocks of whole rows of this
#: many float32 bytes, each through one of ``_SLOTS`` pinned host slots
_BLOCK_BYTES = 32 << 20
_SLOTS = 3
#: the threads that read one block of a points file, over disjoint byte
#: ranges: the fastest count of 1, 2, 4, 6 and 8 on an H100's 8-core host
#: (``scripts/kmeans_read_probe.py``)
_READ_THREADS = 8


def _resident_points(points, device: torch.device, dtype: torch.dtype,
                     step) -> tuple[torch.Tensor, int]:
    """``points`` as a resident ``(n, d)`` tensor of ``dtype`` on
    ``device``, and the number of blocks read straight from the file.

    Each block of :data:`_BLOCK_BYTES` of whole rows fills a float32 host
    slot: straight from the file (``os.preadv``, which releases the GIL,
    on :data:`_READ_THREADS` threads) when ``points`` is the whole memory
    map of a C-ordered float32 file (:func:`_whole_map`), else by
    ``np.copyto`` from the array, cast as ``np.array(points, np.float32)``
    casts.  For bf16 the slot rounds to nearest even on the host, into a
    bf16 slot, as ``Tensor.to`` rounds a whole array.  On a CUDA device
    the slots are pinned and each copies to its rows with ``non_blocking``
    on a copy stream while the next block fills; a slot refills after its
    copy's event.  On the CPU the fill writes ``p``'s rows (float32), or
    one slot rounds into them.  ``step`` times the block loop as
    ``kmeans/read_points`` and the drain of the copies and the sync as
    ``kmeans/copy_points``, both with the resident ``bytes``."""
    from_file = _whole_map(points)
    src = points if from_file else np.asarray(points)
    n, d = src.shape
    cuda = device.type == "cuda"
    p = torch.empty((n, d), dtype=dtype, device=device)
    nbytes = p.numel() * p.element_size()
    rows = max(1, _BLOCK_BYTES // (4 * max(d, 1)))
    if cuda or dtype != torch.float32:
        host = [torch.empty((rows, d), dtype=torch.float32, pin_memory=cuda)
                for _ in range(_SLOTS if cuda else 1)]
    else:
        host = None  # the fill writes p's rows
    if cuda:
        rounded = [torch.empty((rows, d), dtype=dtype, pin_memory=True)
                   for _ in host] if dtype != torch.float32 else None
        copy_stream = torch.cuda.Stream(device)
        copy_stream.wait_stream(torch.cuda.current_stream(device))  # p
        copied = [torch.cuda.Event() for _ in host]
    fd = os.open(src.filename, os.O_RDONLY) if from_file else None
    pool = ThreadPoolExecutor(_READ_THREADS) if from_file else None
    blocks = 0
    try:
        with step("kmeans/read_points", bytes=nbytes):
            for b, lo in enumerate(range(0, n, rows)):
                hi = min(lo + rows, n)
                s = b % len(host) if host is not None else 0
                if cuda:
                    copied[s].synchronize()
                fill = p[lo:hi] if host is None else host[s][:hi - lo]
                if from_file:
                    _read_block(pool, fd, src.offset + lo * 4 * d,
                                fill.numpy())
                    blocks += 1
                else:
                    np.copyto(fill.numpy(), src[lo:hi], casting="unsafe")
                if not cuda:
                    if host is not None:
                        p[lo:hi].copy_(fill)
                    continue
                if dtype != torch.float32:
                    fill = rounded[s][:hi - lo].copy_(fill)
                with torch.cuda.stream(copy_stream):
                    p[lo:hi].copy_(fill, non_blocking=True)
                    copied[s].record(copy_stream)
        with step("kmeans/copy_points", bytes=nbytes):
            if cuda:
                torch.cuda.current_stream(device).wait_stream(copy_stream)
                torch.cuda.synchronize(device)
    finally:
        if from_file:
            pool.shutdown()
            os.close(fd)
    return p, blocks


def _whole_map(points) -> bool:
    """Whether ``points`` is the whole memory map of a C-ordered float32
    ``(n, d)`` file, as ``np.load(path, mmap_mode="r")`` returns it: its
    rows are the file's bytes from ``points.offset``.  A slice of a map
    (whose ``base`` is the map's array, and whose ``offset`` is still the
    map's) and a copy-on-write map (``mode="c"``, whose writes the file
    does not see) are not."""
    return (isinstance(points, np.memmap)
            and isinstance(points.base, mmap.mmap) and points.mode != "c"
            and points.dtype == np.float32 and points.ndim == 2
            and points.flags.c_contiguous and points.filename is not None)


def _read_block(pool, fd: int, offset: int, dst: np.ndarray) -> None:
    """Fill ``dst`` with the file's bytes from ``offset``, split into page
    multiples over the pool's threads."""
    buf = memoryview(dst).cast("B")
    part = max(1, -(-buf.nbytes // (_READ_THREADS << 12))) << 12
    for f in [pool.submit(_pread_full, fd, buf[a:a + part], offset + a)
              for a in range(0, buf.nbytes, part)]:
        f.result()


def _pread_full(fd: int, buf: memoryview, offset: int) -> None:
    """``os.preadv`` until ``buf`` is full (a read may return short)."""
    while buf.nbytes:
        got = os.preadv(fd, [buf], offset)
        if not got:
            raise EOFError(f"points file ends before byte {offset}")
        buf, offset = buf[got:], offset + got


def _record_plan(registry, p: torch.Tensor, k: int, precision: str) -> None:
    """The kernel's launch plan for the resident points ``p`` as gauges."""
    index = (p.device.index if p.device.index is not None
             else torch.cuda.current_device())
    n, d = p.shape
    pl = plan(index, p.dtype == torch.bfloat16, precision == "bf16", n, d, k)
    for key in ("grid", "resident", "acc_in_smem", "k_pad"):
        registry.set(f"kmeans/plan_{key}", pl[key])


def _no_step(name: str, **attrs):
    """``Obs.step`` outside a job: times nothing."""
    return NULL_SPAN


def _fetch(c: torch.Tensor) -> np.ndarray:
    """The centroids to the host: the fetch blocks on the device chain that
    produced them, a wait the job's ``device/compute_ms`` records (the JAX
    package's ``parallel/kmeans.py:395-422``)."""
    t0 = time.perf_counter()
    out = c.cpu().numpy()
    observe_device_wait(t0)
    return out


@observed("kmeans/stream_step", dynamic=("rows",))
def _stream_step(block, c, acc, chunk_rows: int, *, k: int, precision: str,
                 first: bool, last: bool, rows: int):
    """One staged block of the streamed fit (JAX
    ``parallel/kmeans.py:_build_stream_step``): the fused assign + sum of
    each ``chunk_rows`` chunk among the block's first ``rows`` rows, added
    to the ``(k, d+1)`` f32 partial ``acc`` in chunk order (zeroed first on
    an iteration's first block).  The last block of an iteration returns
    the moved centroids (an empty centroid keeps its position); any other
    returns ``acc``."""
    d = c.shape[1]
    if first:
        acc.zero_()
    for lo in range(0, rows, chunk_rows):
        sums, counts = fused_assign_sum(
            block[lo:min(lo + chunk_rows, rows)], c, k, precision)
        acc[:, :d] += sums
        acc[:, d] += counts
    if not last:
        return acc
    counts = acc[:, d:]
    return torch.where(counts > 0, acc[:, :d] / counts.clamp_min(1.0), c)


def kmeans_fit_streamed_device(path: str, centroids, iters: int = 1,
                               chunk_rows: int = 1 << 21, device=None,
                               precision: str = "highest",
                               timings: dict | None = None, on_iter=None,
                               pipeline_depth: int = 2,
                               dispatch_batch: int = 0,
                               partials: list | None = None) -> np.ndarray:
    """k-means beyond the device fit: every iteration streams the points of
    the ``.npy`` file at ``path`` through ``device`` in chunks of
    ``chunk_rows`` rows; the centroids stay on the device.

    Each chunk is one call of the fused assign + sum on its real rows (the
    kernel takes any row count, so a short tail chunk needs no padding);
    its ``(k, d+1)`` partial adds to an f32 accumulator in chunk order,
    starting from zeros, and the last chunk of an iteration moves every
    non-empty centroid to its mean (an empty one keeps its position).
    Chunks stage in blocks of B through a
    :class:`~map_oxidize_tpu_torch.runtime.pipeline.StagingRing` of
    ``pipeline_depth + 1`` slots, one ``kmeans/stream_step`` dispatch per
    block; with ``pipeline_depth > 1`` one
    :class:`~map_oxidize_tpu_torch.runtime.pipeline.BlockStager` thread
    spans every iteration, filling pinned buffers from the memory map and
    copying them on a copy stream while the device works on earlier
    blocks.  The accumulation order is the left fold of per-chunk partials
    whatever B and the depth, so the result is bit-identical across both.
    In ``bf16`` mode the chunks are rounded to bf16 on the host before the
    copy (half the bytes over the link).

    ``dispatch_batch`` is B; 0 (auto) resolves it through
    :func:`~map_oxidize_tpu_torch.runtime.dispatch.resolve_dispatch_batch`
    (JAX ``parallel/kmeans.py:270-292``) from the measured launch floor,
    the measured host produce of one chunk (probed here: a real fault-in
    and copy of the first chunk, skipped when the memo already holds the
    resolution) and the measured or roofline device compute per chunk,
    capped by the device memory; inside a job the choice and its inputs
    land as ``dispatch/*`` and ``plan/dispatch_*`` gauges and the probe in
    ``attrib/probe_ms``.

    ``on_iter(i, centroids_np)`` sees the state after each iteration (one
    ``(k, d)`` fetch).  ``partials``, a list, receives each iteration's
    ``(k, d+1)`` accumulator (sums, counts) as NumPy (one more fetch).
    ``timings`` receives ``feed_s`` (the whole block loop, synchronised),
    ``dispatch_batch`` and, when a stager thread ran, ``feed_wait_s`` and
    ``overlap_ratio``.  Inside a job (``obs.context``): the set-up (staging
    ring, centroid copy) counts into its ``attrib/init_ms``, the stager
    feeds its live ``pipeline/*`` counters, the blocking centroid
    fetches land in its ``device/compute_ms``, and the fused assign +
    sum's calls in ``kmeans/assign_sum_calls``."""
    from map_oxidize_tpu_torch.runtime.dispatch import (
        has_cached_auto,
        record_dispatch_batch,
        resolve_dispatch_batch,
    )
    from map_oxidize_tpu_torch.runtime.pipeline import (
        BlockStager,
        StagingRing,
        chunk_groups,
        staged_blocks,
    )

    if device is None:
        from map_oxidize_tpu_torch.runtime.engine import pick_device

        device = pick_device("cuda")
    device = torch.device(device)
    obs = current_obs()
    # the set-up window (the B resolution, the staging ring's pinned
    # buffers and device blocks, the centroid copy) runs inside the
    # driver's iterate phase: measured so it lands in the attribution's
    # setup bucket; the produce probe counts as host produce instead
    t_init = time.perf_counter()
    pts = np.load(path, mmap_mode="r")
    n, d = pts.shape
    c = torch.from_numpy(np.array(centroids, np.float32)).to(device)
    k = c.shape[0]
    chunk_rows = max(1, min(chunk_rows, n))
    starts = list(range(0, n, chunk_rows))
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    chunk_device_bytes = chunk_rows * d * dtype.itemsize
    flops_per_chunk = assign_sum_ops(chunk_rows, k, d)
    produce_ms = None
    if (dispatch_batch == 0 and len(starts) > 1
            and not has_cached_auto("kmeans/stream_step",
                                    chunk_device_bytes, flops_per_chunk)):
        t0 = time.perf_counter()
        # a real fault-in + copy (+ rounding): a view would measure ~0
        torch.from_numpy(np.array(pts[:chunk_rows], np.float32)).to(dtype)
        produce_ms = (time.perf_counter() - t0) * 1e3
    B, binfo = resolve_dispatch_batch(
        dispatch_batch, n_chunks=len(starts),
        chunk_device_bytes=chunk_device_bytes,
        flops_per_chunk=flops_per_chunk, produce_ms=produce_ms,
        program="kmeans/stream_step", precision=precision)
    if obs is not None:
        record_dispatch_batch(obs.registry, B, binfo,
                              fresh_probe_ms=produce_ms)
    groups = chunk_groups(starts, B)
    n_blocks = len(groups)
    ring = StagingRing(pipeline_depth + 1, B * chunk_rows, d, dtype, device)
    acc = torch.zeros((k, d + 1), dtype=torch.float32, device=device)

    def _stage(item):
        seq, group = item
        lo, hi = group[0], min(group[-1] + chunk_rows, n)
        return seq, ring.stage(seq, pts[lo:hi]), group

    if obs is not None:
        obs.registry.count("attrib/init_ms",
                           (time.perf_counter() - t_init) * 1e3
                           - (produce_ms or 0.0))
    calls = calls_on_this_thread()
    t0 = time.perf_counter()
    # ONE stager spans every iteration: the blocks do not depend on the
    # centroids, so iteration i+1's first block stages while iteration i's
    # last block computes
    all_groups = list(enumerate(groups * iters))
    pf = None
    if pipeline_depth > 1 and len(all_groups) > 1:
        pf = BlockStager(all_groups, _stage, depth=pipeline_depth - 1,
                         name="kmeans/stage", obs=obs)
        blocks = iter(pf)
    else:
        blocks = staged_blocks(all_groups, _stage)
    for seq, slot, group in blocks:
        bi = seq % n_blocks
        out = _stream_step(
            ring.acquire(slot), c, acc, chunk_rows, k=k, precision=precision,
            first=bi == 0, last=bi == n_blocks - 1,
            rows=min(group[-1] + chunk_rows, n) - group[0],
            observed_chunks=len(group))
        ring.release(slot, seq)
        if bi == n_blocks - 1:
            c = out
            if partials is not None:
                partials.append(acc.cpu().numpy())
            if on_iter is not None:
                on_iter(seq // n_blocks + 1, _fetch(c))
    out = _fetch(c)
    if obs is not None:
        obs.registry.count("kmeans/assign_sum_calls",
                           calls_on_this_thread() - calls)
    if timings is not None:
        timings["feed_s"] = time.perf_counter() - t0
        timings["dispatch_batch"] = B
        if pf is not None and pf.produce_s:
            timings["feed_wait_s"] = pf.wait_s
            timings["overlap_ratio"] = round(pf.overlap_ratio, 4)
    return out


def write_centroids(path: str, centroids: np.ndarray) -> None:
    """Atomic centroid writer: writes the EXACT configured path
    (``np.save(str)`` would append '.npy'), temp + rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, np.asarray(centroids, np.float32))
    os.replace(tmp, path)
