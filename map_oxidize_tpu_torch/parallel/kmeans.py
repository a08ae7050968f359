"""Sharded k-means: data-parallel device iterations over the mesh.

The port of the JAX package's ``parallel/kmeans.py`` (``make_fit_fn`` :36,
``_build_stream_step`` :125, ``kmeans_fit_streamed`` :181,
``kmeans_fit_sharded`` :433).  The points are split row-wise over the
shards, the centroids are on every slot, and each iteration is per-shard
work joined by ONE ``(k, d+1)`` psum of the partial sums and counts: the
collective moves centroids, never points.

Each shard's partial is one call of the port's fused assign + sum
(:func:`~map_oxidize_tpu_torch.ops.kmeans_kernel.fused_assign_sum`: the
``kmeans_assign_sum`` kernel on the card, its plain version on the CPU),
as in the port's single-device fits.  (The JAX package's sharded fit calls
its XLA ``assign_and_sum`` there, not its Pallas kernel.)  The partials
are summed in shard order on slot 0 (:func:`~map_oxidize_tpu_torch.
parallel.mesh.psum`), so two sharded runs are bit-equal.  A shard's rows
are the JAX split of the points padded to a multiple of S with zero
weight: the padding's exact zeros are left out instead, so a trailing
shard may hold fewer rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from map_oxidize_tpu_torch.obs.compile import assign_sum_ops, observed
from map_oxidize_tpu_torch.obs.context import current_obs
from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum
from map_oxidize_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    ShardedStagingRing,
    make_mesh,
    psum,
    shard_bounds,
)
from map_oxidize_tpu_torch.workloads.kmeans import _fetch


def _partial(p: torch.Tensor, c: torch.Tensor, k: int, precision: str):
    """One shard's ``(k, d+1)`` partial: sums and counts of its rows."""
    if p.shape[0] == 0:
        return torch.zeros((k, c.shape[1] + 1), dtype=torch.float32,
                           device=c.device)
    sums, counts = fused_assign_sum(p, c, k, precision)
    return torch.cat([sums, counts[:, None]], dim=1)


def _move(acc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Every non-empty centroid to its mean; an empty one stays."""
    d = c.shape[1]
    counts = acc[:, d:]
    return torch.where(counts > 0, acc[:, :d] / counts.clamp_min(1.0), c)


def _fit(mesh: Mesh, p: list, c: list, k: int, loop_iters: int,
         precision: str = "highest") -> list:
    """``loop_iters`` iterations (JAX ``make_fit_fn``'s body): per shard
    the fused assign + sum of its block, ONE psum, the centroid move."""
    for _ in range(loop_iters):
        parts = mesh.run(lambda ps, cs: _partial(ps, cs, k, precision),
                         p, c)
        c = mesh.replicate(_move(psum(mesh, parts)[0], c[0]))
    return c


#: the resident sharded fit under the launch ledger (JAX
#: ``kmeans/fit_sharded``)
fit_sharded = observed("kmeans/fit_sharded", _fit)


def kmeans_fit_sharded(points, centroids, iters: int = 1, mesh=None,
                       num_shards: int = 0, backend: str = "cuda",
                       on_iter=None, timings: dict | None = None,
                       precision: str = "highest") -> np.ndarray:
    """``iters`` k-means iterations with the points split over the mesh.

    ``points``: host ``(n, d)`` float32 (a memory map is read once);
    shard ``s`` holds rows ``shard_bounds(n, S)[s]``, stored as bf16 in
    ``bf16`` mode.  Returns the final centroids as NumPy ``(k, d)``.
    ``on_iter(i, centroids_np)`` runs one iteration per call, fetching the
    centroids after each.  ``timings`` receives ``transfer_s`` (the points
    to the slots) and, without ``on_iter``, ``iter_s``."""
    if mesh is None:
        mesh = make_mesh(num_shards, backend)
    S = mesh.shape[SHARD_AXIS]
    obs = current_obs()
    centroids = np.array(centroids, np.float32)  # a memory map's rows
    n, d = points.shape
    k = centroids.shape[0]
    t0 = time.perf_counter()
    p = []
    for (lo, hi), dev in zip(shard_bounds(n, S), mesh.devices):
        block = torch.from_numpy(np.array(points[lo:hi], np.float32))
        if precision == "bf16":
            block = block.to(torch.bfloat16)  # round to nearest even
        p.append(block.to(dev))
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if timings is not None:
        timings["transfer_s"] = time.perf_counter() - t0
    c = mesh.replicate(torch.from_numpy(centroids).to(mesh.devices[0]))
    if obs is not None and S > 1:
        # one (k, d+1) partials psum per iteration: the fit's only
        # collective
        for _ in range(iters):
            obs.registry.comm("psum", "kmeans/fit_sharded",
                              S * k * (d + 1) * 4, shape=(k, d + 1))
    t0 = time.perf_counter()
    if on_iter is None:
        out = _fetch(fit_sharded(mesh, p, c, k, iters, precision)[0])
        if timings is not None:
            timings["iter_s"] = time.perf_counter() - t0
        return out
    for i in range(iters):
        c = fit_sharded(mesh, p, c, k, 1, precision)
        on_iter(i + 1, _fetch(c[0]))
    return _fetch(c[0])


def _stream_step(mesh: Mesh, blocks: list, c: list, acc: torch.Tensor,
                 per_shard: int, *, k: int, precision: str, first: bool,
                 last: bool, rows: list):
    """One staged block of the sharded streamed fit (JAX
    ``_build_stream_step``): for each chunk of the block, each shard's
    fused assign + sum of its ``rows[s][i]`` rows, ONE ``(k, d+1)`` psum,
    added to ``acc`` in chunk order (zeroed first on an iteration's first
    block).  The last block of an iteration returns the moved centroids
    on every slot; any other returns ``acc``."""
    if first:
        acc.zero_()
    for i in range(len(rows[0])):
        parts = mesh.run(
            lambda b, cs, r: _partial(b[i * per_shard:i * per_shard + r],
                                      cs, k, precision),
            blocks, c, [r[i] for r in rows])
        acc += psum(mesh, parts)[0]
    if not last:
        return acc
    return mesh.replicate(_move(acc, c[0]))


#: the sharded streamed step under the launch ledger, by the single-device
#: step's name (JAX ``kmeans/stream_step`` serves both); the per-shard row
#: counts are data, not shape
stream_step = observed("kmeans/stream_step", _stream_step,
                       dynamic=("rows",))


def kmeans_fit_streamed(path: str, centroids, iters: int = 1,
                        chunk_rows: int = 1 << 21, mesh=None,
                        num_shards: int = 0, backend: str = "cuda",
                        precision: str = "highest",
                        timings: dict | None = None, on_iter=None,
                        pipeline_depth: int = 2,
                        dispatch_batch: int = 0,
                        partials: list | None = None) -> np.ndarray:
    """k-means beyond the device fit THROUGH the mesh (JAX
    ``kmeans_fit_streamed`` with ``num_shards``): every iteration streams
    the ``.npy`` file at ``path`` in chunks of ``chunk_rows`` rows
    (rounded to a multiple of S), each chunk split row-wise over the
    shards, B chunks per staged block, one ``kmeans/stream_step`` per
    block.  Each shard stages its rows through its own pinned ring
    (:class:`~map_oxidize_tpu_torch.parallel.mesh.ShardedStagingRing`),
    filled by one :class:`~map_oxidize_tpu_torch.runtime.pipeline.
    BlockStager` thread across every iteration.  B is resolved as in the
    single-device stream (``dispatch_batch`` 0 = auto).  ``partials``, a
    list, receives each iteration's psummed ``(k, d+1)`` accumulator as
    NumPy.  ``timings`` receives ``feed_s``, ``dispatch_batch`` and, with
    a stager thread, ``feed_wait_s`` and ``overlap_ratio``."""
    from map_oxidize_tpu_torch.runtime.dispatch import (
        has_cached_auto,
        record_dispatch_batch,
        resolve_dispatch_batch,
    )
    from map_oxidize_tpu_torch.runtime.pipeline import (
        BlockStager,
        chunk_groups,
        staged_blocks,
    )

    obs = current_obs()
    t_init = time.perf_counter()
    if mesh is None:
        mesh = make_mesh(num_shards, backend)
    S = mesh.shape[SHARD_AXIS]
    pts = np.load(path, mmap_mode="r")
    n, d = pts.shape
    centroids = np.array(centroids, np.float32)  # a memory map's rows
    k = centroids.shape[0]
    # never past the dataset, and S | chunk rows: one shape per shard
    chunk_rows = min(chunk_rows, -(-n // S) * S)
    chunk_rows = -(-chunk_rows // S) * S
    r = chunk_rows // S
    starts = list(range(0, n, chunk_rows))
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    chunk_device_bytes = chunk_rows * d * dtype.itemsize
    flops_per_chunk = assign_sum_ops(chunk_rows, k, d)
    produce_ms = None
    if (dispatch_batch == 0 and len(starts) > 1
            and not has_cached_auto("kmeans/stream_step",
                                    chunk_device_bytes, flops_per_chunk)):
        t0 = time.perf_counter()
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
    ring = ShardedStagingRing(mesh, pipeline_depth + 1, B * r, d, dtype)
    c = mesh.replicate(torch.from_numpy(centroids).to(mesh.devices[0]))
    acc = torch.zeros((k, d + 1), dtype=torch.float32,
                      device=mesh.devices[0])

    def _stage(item):
        seq, group = item
        parts = [[] for _ in range(S)]
        rows = [[] for _ in range(S)]
        for st in group:
            # shard s owns rows [s*r, (s+1)*r) of every chunk; the tail
            # chunk's padding rows are left out
            m = min(chunk_rows, n - st)
            for s in range(S):
                lo, hi = min(s * r, m), min((s + 1) * r, m)
                parts[s].append(pts[st + lo:st + hi])
                rows[s].append(hi - lo)
        return seq, ring.stage(seq, parts), rows

    if obs is not None:
        obs.registry.count("attrib/init_ms",
                           (time.perf_counter() - t_init) * 1e3
                           - (produce_ms or 0.0))
    t0 = time.perf_counter()
    all_groups = list(enumerate(groups * iters))
    pf = None
    if pipeline_depth > 1 and len(all_groups) > 1:
        pf = BlockStager(all_groups, _stage, depth=pipeline_depth - 1,
                         name="kmeans/stage", obs=obs)
        blocks = iter(pf)
    else:
        blocks = staged_blocks(all_groups, _stage)
    psum_bytes = S * k * (d + 1) * 4
    for seq, slot, rows in blocks:
        bi = seq % n_blocks
        out = stream_step(mesh, ring.acquire(slot), c, acc, r, k=k,
                          precision=precision, first=bi == 0,
                          last=bi == n_blocks - 1, rows=rows,
                          observed_chunks=len(rows[0]))
        ring.release(slot, seq)
        if obs is not None and S > 1:
            # one (k, d+1) psum per logical chunk
            for _ in range(len(rows[0])):
                obs.registry.comm("psum", "kmeans/stream_step", psum_bytes,
                                  shape=(k, d + 1))
        if bi == n_blocks - 1:
            c = out
            if partials is not None:
                partials.append(acc.cpu().numpy())
            if on_iter is not None:
                on_iter(seq // n_blocks + 1, _fetch(c[0]))
    out = _fetch(c[0])
    if timings is not None:
        timings["feed_s"] = time.perf_counter() - t0
        timings["dispatch_batch"] = B
        if pf is not None and pf.produce_s:
            timings["feed_wait_s"] = pf.wait_s
            timings["overlap_ratio"] = round(pf.overlap_ratio, 4)
    return out
