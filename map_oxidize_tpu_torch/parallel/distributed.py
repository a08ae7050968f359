"""Multi-process execution: the drivers of a job that spans several OS
processes.  The port of the JAX package's ``parallel/distributed.py``
(whole).

There, ``jax.distributed`` wires the coordination service, a mesh spans
every process's devices and the same XLA programs run over it (Gloo
collectives on the CPU).  Here :func:`init_distributed` starts a
``torch.distributed`` Gloo process group, and the mesh of
:mod:`map_oxidize_tpu_torch.parallel.mesh` deals its S slots S/P to each
process: each process keeps its shards' work on its own device (on one
card: S/P virtual slots on ``cuda:0``), and only the rows that cross
processes go through host buffers and Gloo.  The engines and the host
syncs that read a value every process must agree on are the sharded ones
with replicated reads (:class:`DistributedReduceEngine`,
:class:`DistributedCollectEngine`):

* **feed**: each process contributes ``feed_batch / P`` rows per round to
  its local slots (the rows ``make_array_from_process_local_data`` would
  place there).  Processes advance in lockstep: one tiny integer sum per
  round (``dist/flag_psum``) decides whether anyone still has rows (every
  process calls every collective the same number of times, with the same
  shapes: a Gloo call with diverging lengths hangs);
* **host syncs** (live-key count, finalize) gather across processes.

Work partition: process ``p`` maps the chunks with ``index % P == p``;
the chunk plan is deterministic from (file size, chunk_bytes), so dividing
the input needs no coordination.  Key strings live in per-process
dictionaries; the top-k winners' strings and each output partition's
misses resolve through two ``process_allgather`` rounds
(:func:`gather_strings`).  With ``--output`` every process writes its hash
partition (``h % P == p``) as ``<output>.part<p>of<P>`` in the
single-process writer's row format: the parts, concatenated and sorted,
are the single-process ``final_result.txt``.

The remote-staged fold (:func:`_run_remote_staged`) needs no process
group at all: every cross-process edge is a manifest on a shared
filesystem (:mod:`map_oxidize_tpu_torch.shuffle.remote`), so a peer killed
mid-shuffle cannot wedge a survivor in a collective.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from map_oxidize_tpu_torch.api import MapOutput, SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.ops.segment_reduce import (
    keys_from_planes,
    planes_from_keys,
)
from map_oxidize_tpu_torch.parallel.collect import (
    ShardedCollectEngine,
    _live_pairs,
    raise_on_exchange_overflow,
)
from map_oxidize_tpu_torch.parallel.mesh import (
    WIRE,
    Mesh,
    all_gather,
    barrier,
    make_mesh,
    process_allgather,
)
from map_oxidize_tpu_torch.parallel.shuffle import _exchange
from map_oxidize_tpu_torch.shuffle.base import resolve_transport
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: how long a process waits, in the rendezvous and in any collective, for
#: its peers (Gloo's default is 30 minutes).  A peer that dies closes its
#: sockets and the survivor's next collective raises at once; this bound
#: covers a peer that hangs without dying.
GROUP_TIMEOUT_S = 120.0


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Start the Gloo process group of a multi-process job (JAX
    ``init_distributed`` :63).  ``coordinator`` is ``host:port`` (the same
    on every process; process 0 serves the rendezvous there).  Must run
    before the job builds its mesh.  A second call with the same world is
    a no-op."""
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_world_size() != num_processes
                or dist.get_rank() != process_id):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} processes is "
                f"already up as rank {dist.get_rank()}")
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _log.info("process group initialised (gloo, %s): process %d/%d",
              coordinator, process_id, num_processes)


def shutdown_distributed() -> None:
    """The end of a multi-process job: a last barrier (no process leaves
    while a peer still needs the group), then the group is destroyed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# --- the lockstep flag -------------------------------------------------------


def _flag_psum(mesh: Mesh, local: np.ndarray) -> int:
    """The ``[S]`` int32 flag vector (this process's ``[S/P]`` slice)
    summed over every process: an integer sum, so Gloo's ``all_reduce``
    is exact in any order."""
    total = int(local.sum())
    if not mesh.distributed:
        return total
    import torch.distributed as dist

    from map_oxidize_tpu_torch.parallel.mesh import _sent

    t = torch.tensor([total], dtype=torch.int64)
    dist.all_reduce(t)
    _sent(8 * (mesh.n_processes - 1))
    return int(t[0])


#: the flag psum under the launch ledger (JAX ``dist/flag_psum``)
flag_psum = observed("dist/flag_psum", _flag_psum)


def _any_remaining(engine, i_have_rows: bool,
                   rows: "int | None" = None) -> int:
    """Global sum over processes (one tiny psum): every process calls this
    once per round, and a positive sum means someone still has rows.
    With ``rows``, this process contributes its staged row count for the
    coming round instead of a 0/1 flag, so the sum is the GLOBAL rows
    entering the round: the count every process reads identically, which
    the collect engine's disk demotion trips on (JAX ``_any_remaining``
    :540).  The round blocks the host, so its wall is the collective's
    latency, recorded into ``dist/flag_wait_ms`` and the comms
    observatory (a fast process's wait is time blocked on the slowest)."""
    S = engine.S
    if rows is None:
        local = np.full(S // engine.n_proc, 1 if i_have_rows else 0,
                        np.int32)
    else:
        local = np.zeros(S // engine.n_proc, np.int32)
        local[0] = int(rows) if i_have_rows else 0
    t0 = time.perf_counter()
    out = flag_psum(engine.mesh, local)
    obs = engine.obs
    if obs is not None:
        wall_ms = (time.perf_counter() - t0) * 1e3
        obs.registry.observe("dist/flag_wait_ms", wall_ms)
        # payload: the [S] int32 flag vector, summed to every shard
        obs.registry.comm("psum", "dist/flag_psum", 4 * S * S,
                          shape=(S,), latency_ms=wall_ms)
    return out


def _check_divides(S: int, n_proc: int, feed_batch: int) -> None:
    if S % n_proc:
        raise ValueError(
            f"shard count {S} must divide by process count {n_proc} "
            "(every process owns an equal mesh slice)")
    if feed_batch % n_proc:
        raise ValueError("feed_batch must divide by process count")


def _padded(a: np.ndarray, n: int, fill, dtype) -> np.ndarray:
    p = np.full((n,) + a.shape[1:], fill, dtype)
    p[:a.shape[0]] = a
    return p


# --- the fold engine ---------------------------------------------------------


class DistributedReduceEngine:
    """Multi-process wrapper around the port's ``ShardedReduceEngine``
    (JAX ``DistributedReduceEngine`` :85).  Composition: the wrapped
    engine's merge, top-k and growth run unchanged over a mesh whose
    collectives cross processes; the host syncs read values every process
    agrees on (the live-key count is a global max, the finalized state a
    gather in global shard order)."""

    def __init__(self, config: JobConfig, reducer=None, mesh=None,
                 exchange_method: str = "all_to_all"):
        from map_oxidize_tpu_torch.parallel.engine import ShardedReduceEngine

        self.mesh = mesh if mesh is not None else make_mesh(
            config.num_shards, config.backend)
        self._eng = ShardedReduceEngine(
            config, reducer if reducer is not None else SumReducer(),
            mesh=self.mesh, exchange_method=exchange_method)
        # the growth decision reads the GLOBAL live count: every process
        # then grows (or not) in the same round
        self._eng._read_live = self._read_live
        self.n_proc = self.mesh.n_processes
        self.proc = self.mesh.process
        _check_divides(self._eng.S, self.n_proc, self._eng.feed_batch)
        #: rows this process contributes to each global merge
        self.local_rows = self._eng.feed_batch // self.n_proc

    @property
    def obs(self):
        return self._eng.obs

    @obs.setter
    def obs(self, value) -> None:
        self._eng.obs = value

    @property
    def S(self) -> int:
        return self._eng.S

    @property
    def rows_fed(self) -> int:
        return self._eng.rows_fed

    def _read_live(self) -> int:
        return int(all_gather(self.mesh, self._eng._n_unique)[0].max())

    def any_remaining(self, i_have_rows: bool) -> bool:
        return _any_remaining(self, i_have_rows) > 0

    def merge_local(self, hi: np.ndarray, lo: np.ndarray,
                    vals: np.ndarray) -> None:
        """One lockstep global merge; this process contributes up to
        ``local_rows`` rows (padded with SENTINEL keys and the reducer's
        identity), dealt over its local slots in order."""
        n = hi.shape[0]
        if n > self.local_rows:
            raise ValueError(f"{n} rows > local_rows {self.local_rows}")
        e = self._eng
        keys = torch.from_numpy(keys_from_planes(
            _padded(hi, self.local_rows, SENTINEL, np.uint32),
            _padded(lo, self.local_rows, SENTINEL, np.uint32)))
        vals = torch.from_numpy(_padded(np.asarray(vals, e.value_dtype),
                                        self.local_rows, e._pad_val,
                                        e.value_dtype))
        if self.mesh.single_device:
            keys, vals = keys.to(e.device), vals.to(e.device)
        e.rows_fed += n
        # the global batch is feed_batch rows, on every process alike
        e._feed(self.mesh.split(keys), self.mesh.split(vals), e.feed_batch)

    def finalize(self):
        """Replicated ``(hi, lo, vals, n_unique)``: every shard's
        accumulator in global shard order, the same on every process."""
        e = self._eng
        e._check_health()
        if e._n_unique is None:
            cap = e.capacity * e.S
            return (np.full(cap, SENTINEL, np.uint32),
                    np.full(cap, SENTINEL, np.uint32),
                    np.zeros(cap, np.int32), 0)
        keys = all_gather(self.mesh, e._keys, tiled=True)[0]
        vals = all_gather(self.mesh, e._vals, tiled=True)[0]
        n = int(all_gather(self.mesh, e._n_unique)[0].sum())
        hi, lo = planes_from_keys(keys)
        return hi, lo, vals.cpu().numpy(), n

    def top_k(self, k: int):
        """Replicated global top-k ``(hi, lo, vals)`` (the JAX engine's
        ``_topk`` straight, with no comms row)."""
        e = self._eng
        keys, vals = e._topk(e._keys, e._vals, k)
        hi, lo = planes_from_keys(keys)
        return hi, lo, vals.cpu().numpy()


# --- the collect engine ------------------------------------------------------


def _route_spill(mesh: Mesh, keys: list, docs: list, *, cap: int, dests,
                 method: str):
    """The spilled rounds' exchange program (JAX ``shuffle/route_spill``
    :366): route the global batch to its owner shards and hand each
    received block straight back; nothing stays on the device."""
    r_keys, r_docs, ovf = _exchange(mesh, keys, docs, cap, dests=dests,
                                    method=method)
    return r_keys, r_docs, ovf[0]


route_spill = observed("shuffle/route_spill", _route_spill)


class DistributedCollectEngine(ShardedCollectEngine):
    """Multi-process sharded collect (JAX ``DistributedCollectEngine``
    :204): the sharded route/append/sort over a mesh whose exchange
    crosses processes, fed by lockstep ``merge_local`` rounds; finalize
    gathers the per-shard sorted runs in global shard order.

    Beyond the device: each process's post-exchange partition (the rows
    its local slots own) is disjoint, so past ``max_rows`` the engine
    spills it to private disk buckets (``hybrid`` demotes mid-job,
    ``disk`` routes every exchanged block there from round one, ``hbm``
    raises).  The demotion trips on the lockstep-summed GLOBAL row count,
    the same on every process, so all processes switch programs in the
    same round (``route_append`` before, ``route_spill`` after)."""

    def __init__(self, config: JobConfig, mesh=None, **kw):
        mesh = mesh if mesh is not None else make_mesh(
            config.num_shards, config.backend)
        self.n_proc = mesh.n_processes
        self.proc = mesh.process
        #: this process's disk-bucket stage (DiskPairStage); None while
        #: rows stay on the device
        self._disk = None
        self._spilled_rows_total = 0
        super().__init__(config, mesh=mesh, **kw)
        _check_divides(self.S, self.n_proc, self.feed_batch)
        self.local_rows = self.feed_batch // self.n_proc
        #: lockstep-summed global rows: what the demotion trips on
        self._global_rows = 0
        #: True once a rows-contributing flag round ran (a driver that
        #: never syncs the global count must not outgrow the cap)
        self._rows_synced = False

    def _activate_disk_transport(self) -> None:
        """Per-process disk staging: rows still cross processes through
        the exchange, but each process drains the rows its local shards
        OWN into private top-bits buckets."""
        from map_oxidize_tpu_torch.shuffle import DiskPairStage

        self._disk = DiskPairStage(
            prefix=f"moxt_dist_spill_p{self.proc}_",
            obs=getattr(self, "_obs", None))

    @property
    def spilled(self) -> bool:
        return self._disk is not None or self._spilled_rows_total > 0

    @property
    def spilled_rows(self) -> int:
        if self._disk is not None:
            return self._disk.rows
        return self._spilled_rows_total

    def any_remaining(self, i_have_rows: bool, rows: "int | None" = None
                      ) -> bool:
        total = _any_remaining(self, i_have_rows, rows)
        if rows is not None:
            self._global_rows += total
            self._rows_synced = True
        return total > 0

    def merge_local(self, hi: np.ndarray, lo: np.ndarray,
                    vals: np.ndarray) -> None:
        """One lockstep exchange round; this process contributes up to
        ``local_rows`` (key, doc) pairs, SENTINEL-padded.  ``vals`` is the
        ``(n, 2)`` uint32 doc-plane pair of the collect feed format."""
        n = hi.shape[0]
        if n > self.local_rows:
            raise ValueError(f"{n} rows > local_rows {self.local_rows}")
        if vals.ndim != 2 or vals.shape[1] != 2 or vals.dtype != np.uint32:
            raise ValueError(
                "collect engines expect (n, 2) uint32 doc planes")
        self.rows_fed += n
        if (self._disk is None and not self._rows_synced
                and self.rows_fed > self.max_rows):
            raise RuntimeError(
                "DistributedCollectEngine crossed max_rows="
                f"{self.max_rows} but the global row count was never "
                "synced: drive the engine through run_distributed_job, "
                "or pass rows= to any_remaining each lockstep round so "
                "the cap (and the disk demotion) can trip "
                "SPMD-consistently")
        if self._disk is None and self._transport.admit(
                self._global_rows, self.max_rows,
                "distributed pair collect (DistributedCollectEngine; "
                "sharding wider — more processes — also shrinks each "
                "process's partition)") == "demote":
            self._demote_to_disk()
        sentinel = np.iinfo(np.int64).max
        keys = np.full(self.local_rows, sentinel, np.int64)
        docs = np.full(self.local_rows, sentinel, np.int64)
        keys[:n] = keys_from_planes(hi, lo)
        docs[:n] = keys_from_planes(vals[:, 0], vals[:, 1])
        k_t = torch.from_numpy(np.stack([keys, docs]))
        if self.mesh.single_device:
            k_t = k_t.to(self.device)
        k_sh = self.mesh.split(k_t.T)
        k_l = [x[:, 0] for x in k_sh]
        d_l = [x[:, 1] for x in k_sh]
        if self._disk is not None:
            self._route_to_spill(k_l, d_l, n)
            return
        from map_oxidize_tpu_torch.parallel.collect import route_append

        self._ensure_room()
        t0 = time.perf_counter()
        self._cursor, ovf = route_append(
            self.mesh, *self._buf, self._cursor, k_l, d_l,
            cap=self.bucket_cap, splitters=self._sp,
            method=self.exchange_method)
        # worst case: every live row of the global batch on one shard
        self._cursor_ub += self.block
        self._overflows.append(ovf)
        self._record_exchange(n, t0, ovf)

    def _route_to_spill(self, keys: list, docs: list, n: int) -> None:
        dests = None
        if self._sp is not None:
            from map_oxidize_tpu_torch.parallel.shuffle import range_dest

            dests = self.mesh.run(range_dest, keys, self._sp)
        t0 = time.perf_counter()
        r_keys, r_docs, ovf = route_spill(
            self.mesh, keys, docs, cap=self.bucket_cap, dests=dests,
            method=self.exchange_method)
        raise_on_exchange_overflow(ovf)
        self._disk.obs = self.obs
        staged = 0
        for rk, rd in zip(r_keys, r_docs):
            got = _live_pairs(rk, rd)
            if got is None:
                continue
            staged += int(got[0].shape[0])
            self._disk.add(*got)
        if self.obs is not None and staged:
            # bounded-residency evidence: host rows resident at once
            self.obs.registry.gauge_max("shuffle/peak_staged_rows", staged)
        self._record_exchange(n, t0, ovf, program="shuffle/route_spill")

    def _demote_to_disk(self) -> None:
        """The hybrid transport's RESIDENT -> SPILLED transition (JAX
        ``_demote_to_disk`` :427).  Every process trips in the SAME round
        (the trip reads the lockstep-summed global rows), drains the rows
        its local slots own into its private disk buckets (a local read:
        the partitions are disjoint) and frees the buffers."""
        from map_oxidize_tpu_torch.shuffle import record_demotion

        self._check_exchange_overflows()
        _log.info(
            "distributed collect crossed max_rows=%d globally; process "
            "%d demotes its shard partition to per-process disk buckets",
            self.max_rows, self.proc)
        self._activate_disk_transport()
        self._disk.obs = self.obs
        with record_demotion(self.obs, self.rows_fed, "hbm", "disk",
                             shards=self.S, processes=self.n_proc,
                             max_rows=self.max_rows):
            if self._buf is not None:
                for bk, bd in zip(*self._buf):
                    got = _live_pairs(bk, bd)
                    if got is not None:
                        self._disk.add(*got)
                self._buf = None
                self._cursor = None
                self._cursor_ub = 0

    def finalize(self):
        """Route + sort everything fed; the replicated ``(keys_u64,
        docs_i64)``: every shard's sorted run, in global shard order."""
        from map_oxidize_tpu_torch.parallel.collect import sort_sharded

        if self.spilled:
            raise RuntimeError(
                "per-process spill is active; use finalize_spilled_csr")
        self._check_exchange_overflows()
        if self._buf is None:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        s_keys, s_docs = sort_sharded(self.mesh, *self._buf)
        counts = np.zeros(self.mesh.n_local, np.int64)
        keys_parts, docs_parts = [], []
        for s in range(self.mesh.n_local):
            got = _live_pairs(s_keys[s], s_docs[s])
            if got is None:
                continue
            counts[s] = got[0].shape[0]
            keys_parts.append(got[0])
            docs_parts.append(got[1])
        keys = (np.concatenate(keys_parts) if keys_parts
                else np.empty(0, np.uint64))
        docs = (np.concatenate(docs_parts) if docs_parts
                else np.empty(0, np.int64))
        all_counts = process_allgather(self.mesh, counts)   # (P, S/P)
        dp = getattr(self.obs, "dataplane", None) if self.obs else None
        if dp is not None:
            dp.record_observed_rows(all_counts.reshape(-1))
        return _allgather_rows(self.mesh, all_counts.sum(axis=1), keys,
                               docs)

    def finalize_spilled_csr(self):
        """Bucket-by-bucket CSR finalize of THIS process's disk partition.
        The intra-bucket sort is the full (key, doc) lexsort: rows of
        different processes' chunks interleave per term, and (term, doc)
        pairs are distinct, so the lexsort restores oracle order."""
        if self._disk is None:
            raise RuntimeError("engine did not spill; use finalize")
        self._check_exchange_overflows()
        self._spilled_rows_total = self._disk.rows
        terms, offsets, docs, holder, peak = self._disk.drain_csr(
            self._sort_kd)
        self._disk = None
        if self.obs is not None and peak:
            self.obs.registry.gauge_max("shuffle/peak_staged_rows", peak)
        return terms, offsets, docs, holder

    def _sort_kd(self, keys, docs):
        """The spilled drain's intra-bucket sort: the full (key, doc)
        lexsort; under ``pair_order='lex'`` the doc plane compares
        UNSIGNED (dataflow payloads are arbitrary u64 bit patterns)."""
        d = docs.view(np.uint64) if self.pair_order == "lex" else docs
        order = np.lexsort((d, keys))
        return keys[order], docs[order]

    def finalize_spilled_runs(self):
        """Sorted-run drain of THIS process's disk partition (the
        distributed sort's spilled finalize): lexsorted ``(keys, docs)``
        blocks in ascending top-bit bucket order.  Under a range partition
        a process's shards own a contiguous key range, so the part files
        concatenate, process-major, into the globally sorted artifact."""
        if self._disk is None:
            raise RuntimeError("engine did not spill; use finalize")
        self._check_exchange_overflows()
        self._spilled_rows_total = self._disk.rows
        disk, self._disk = self._disk, None
        return disk.drain_sorted(self._sort_kd)

    def feed(self, out):
        raise NotImplementedError(
            "DistributedCollectEngine is fed via merge_local (lockstep); "
            "single-process feed() would deadlock the other processes")


def _allgather_rows(mesh: Mesh, counts: np.ndarray, keys: np.ndarray,
                    docs: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Concatenate every process's ``(keys u64, docs i64)`` rows in process
    order: zero-padded to the longest process's rows (``counts``, the
    same on every process), gathered, trimmed."""
    cap = int(counts.max()) if counts.size else 0
    if cap == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    pad = np.zeros((2, cap), np.int64)
    pad[0, :keys.shape[0]] = keys.view(np.int64)
    pad[1, :docs.shape[0]] = docs
    g = process_allgather(mesh, pad)
    k = np.concatenate([g[q, 0, :int(counts[q])] for q in range(g.shape[0])])
    d = np.concatenate([g[q, 1, :int(counts[q])] for q in range(g.shape[0])])
    return k.view(np.uint64), d


# --- strings and small gathers -----------------------------------------------


def _default_mesh() -> Mesh:
    """A one-slot mesh that knows this process's slot: the host gathers
    below need only the process group, not the job's devices."""
    from map_oxidize_tpu_torch.parallel.mesh import process_slot

    p, n = process_slot()
    return Mesh([torch.device("cpu")], process=p, n_processes=n)


def gather_strings(hashes: "list[int]", dictionary,
                   obs=None) -> "dict[int, bytes]":
    """Resolve key bytes for ``hashes`` across every process (JAX
    ``gather_strings`` :582): each process contributes what its local
    dictionary knows, in two ``process_allgather`` rounds (per-hash byte
    lengths, then the padded byte planes).  Disagreeing resolutions of
    one hash abort (a cross-process 64-bit collision).  A hash nobody
    resolves is absent.  Every process calls this with the SAME hash
    list (it is a collective).  With ``obs`` both rounds land in the
    comms observatory."""
    k = len(hashes)
    if k == 0:
        return {}
    mesh = _default_mesh()
    d = dictionary.materialized()
    local = [d.get(h) for h in hashes]
    # -1 = unknown here, so a zero-length key resolves to b""
    lens = np.array([-1 if b is None else len(b) for b in local], np.int32)
    t0 = time.perf_counter()
    all_lens = process_allgather(mesh, lens)
    if obs is not None:
        P = all_lens.shape[0]
        obs.registry.comm("all_gather", "dist/gather_strings",
                          P * P * lens.nbytes, shape=lens.shape,
                          latency_ms=(time.perf_counter() - t0) * 1e3)
    maxlen = int(all_lens.max())
    if maxlen < 0:
        return {}
    buf = np.zeros((k, max(maxlen, 1)), np.uint8)
    for i, b in enumerate(local):
        if b:
            buf[i, :len(b)] = np.frombuffer(b, np.uint8)
    t0 = time.perf_counter()
    all_buf = process_allgather(mesh, buf)
    if obs is not None:
        P = all_buf.shape[0]
        obs.registry.comm("all_gather", "dist/gather_strings",
                          P * P * buf.nbytes, shape=buf.shape,
                          latency_ms=(time.perf_counter() - t0) * 1e3)
    out: dict[int, bytes] = {}
    for i, h in enumerate(hashes):
        for p in range(all_lens.shape[0]):
            ln = int(all_lens[p, i])
            if ln < 0:
                continue
            b = bytes(all_buf[p, i, :ln])
            prev = out.get(h)
            if prev is not None and prev != b:
                raise ValueError(
                    f"cross-process 64-bit collision: {prev!r} and {b!r} "
                    f"both hash to {h:#x}")
            out[h] = b
    return out


def _allgather_union(local: np.ndarray, obs=None) -> np.ndarray:
    """Global sorted-unique union of each process's u64 hash list (two
    allgather rounds: counts, then zero-padded planes), identical on
    every process, so it can feed :func:`gather_strings`."""
    mesh = _default_mesh()
    local = np.asarray(local, np.uint64)
    all_n = process_allgather(mesh, np.array([local.shape[0]], np.int32)
                              ).reshape(-1)
    cap = int(all_n.max()) if all_n.size else 0
    if cap == 0:
        return np.empty(0, np.uint64)
    pad = np.zeros(cap, np.uint64)
    pad[:local.shape[0]] = local
    t0 = time.perf_counter()
    planes = process_allgather(mesh, pad)
    if obs is not None:
        P = planes.shape[0]
        # the JAX package ships (2, cap) u32 planes: the same bytes
        obs.registry.comm("all_gather", "dist/hash_union",
                          P * P * pad.nbytes, shape=(2, cap),
                          latency_ms=(time.perf_counter() - t0) * 1e3)
    return np.unique(np.concatenate(
        [planes[i, :int(all_n[i])] for i in range(planes.shape[0])]))


def resolve_strings_for(owned: "list[int]", dictionary,
                        obs=None) -> "dict[int, bytes]":
    """Resolve key bytes for a DISJOINT partition of the key space (each
    process passes the hashes it owns): the local dictionary first, the
    union of every process's misses through one :func:`gather_strings`
    round.  A collective; an unresolvable key is an engine bug and
    raises."""
    owned = [int(h) for h in owned]
    d = dictionary.materialized()
    missing = np.array([h for h in owned if h not in d], np.uint64)
    gathered = gather_strings(
        [int(h) for h in _allgather_union(missing, obs)], dictionary, obs)
    out: dict[int, bytes] = {}
    for h in owned:
        b = d.get(h)
        if b is None:
            b = gathered.get(h)
        if b is None:
            raise RuntimeError(
                f"no process could resolve key {h:#x} — its mapper "
                "dictionary should have recorded it")
        out[h] = b
    return out


def partition_strings(hashes, dictionary, proc: int, n_proc: int,
                      obs=None) -> "dict[int, bytes]":
    """Resolve key bytes for THIS process's hash partition
    (``h % n_proc == proc``) of ``hashes`` (a collective)."""
    return resolve_strings_for(
        [int(h) for h in hashes if int(h) % n_proc == proc],
        dictionary, obs)


def _allgather_u64(vals: np.ndarray, obs=None,
                   program: str = "dist/spill_merge") -> np.ndarray:
    """``process_allgather`` of a fixed-width u64 vector -> ``(P, k)``;
    every process passes the same ``k``."""
    vals = np.ascontiguousarray(vals, np.uint64)
    t0 = time.perf_counter()
    g = process_allgather(_default_mesh(), vals)
    if obs is not None:
        P = g.shape[0]
        obs.registry.comm("all_gather", program, P * P * vals.nbytes,
                          shape=(2,) + vals.shape,
                          latency_ms=(time.perf_counter() - t0) * 1e3)
    return g


def _allgather_i64(vals: np.ndarray, obs=None,
                   program: str = "dist/spill_merge") -> np.ndarray:
    """Signed twin of :func:`_allgather_u64`."""
    u = _allgather_u64(np.asarray(vals, np.int64).view(np.uint64), obs,
                       program)
    return u.view(np.int64)


def _spilled_invertedindex_result(config: JobConfig, obs, engine,
                                  dictionary, records: int,
                                  flag_rounds: int, flag_s: float,
                                  resumed: int) -> "DistributedResult":
    """Finalize a spilled multi-process inverted index (JAX :763): each
    process drains its private buckets into ITS partition's CSR (disjoint
    by owner shard), the global facts reduce over tiny allgathers (term
    and pair totals, k top-k candidates per process), and each process
    writes its partition file (partitioned by owner shard, not
    ``h % P``: the parts still cover the key space disjointly)."""
    from map_oxidize_tpu_torch.io.writer import write_postings_stream

    registry = obs.registry
    P_ = engine.n_proc
    with obs.phase("finalize"):
        terms, offsets, docs, holder = engine.finalize_spilled_csr()
        df = np.diff(offsets)
        k = config.top_k
        if terms.shape[0]:
            order = np.lexsort((terms, -df))[:k]
            cand_t, cand_df = terms[order], df[order]
        else:
            cand_t = np.empty(0, np.uint64)
            cand_df = np.empty(0, np.int64)
        # fixed-width candidate pads (df = -1 marks a pad row)
        pad_t = np.zeros(k, np.uint64)
        pad_df = np.full(k, -1, np.int64)
        pad_t[:cand_t.shape[0]] = cand_t
        pad_df[:cand_df.shape[0]] = cand_df
        all_t = _allgather_u64(pad_t, obs).reshape(-1)
        all_df = _allgather_i64(pad_df, obs).reshape(-1)
        live = all_df >= 0
        all_t, all_df = all_t[live], all_df[live]
        # disjoint candidate partitions: the global top-k is a straight
        # merge, df descending, hash ascending on ties
        sel = np.lexsort((all_t, -all_df))[:k]
        t_hashes = [int(h) for h in all_t[sel]]
        words = gather_strings(t_hashes, dictionary, obs)
        top = [(h, words.get(h), int(c))
               for h, c in zip(t_hashes, all_df[sel])]
        totals = _allgather_i64(np.array(
            [int(terms.shape[0]), int(offsets[-1])], np.int64), obs)
        n_keys = int(totals[:, 0].sum())
        n_pairs = int(totals[:, 1].sum())
    dp = getattr(obs, "dataplane", None)
    if dp is not None:
        # the out-side was recorded per disk bucket during the drain; one
        # collective folds both sides global
        dp.set_records_in(records)
        dp.reduce_distributed(
            lambda v: _allgather_u64(v, obs, "dist/dataplane"),
            expect=(("map_out", "local"), ("reduce_out", "disjoint")))
        dp.resolve_hot_keys(
            gather_strings(dp.hot_hashes(), dictionary, obs).get)
        dp.check_pairs()
    if config.output_path:
        with obs.phase("write"):
            names = resolve_strings_for(terms.tolist(), dictionary, obs)
            owned = sorted((names[int(h)], j)
                           for j, h in enumerate(terms.tolist()))
            n_terms, n_bytes = write_postings_stream(
                partition_output_path(config.output_path, engine.proc, P_),
                ((term, docs[offsets[j]:offsets[j + 1]])
                 for term, j in owned))
        registry.count("dist/partition_terms_written", n_terms)
        registry.count("dist/partition_bytes_written", n_bytes)
    registry.set("spilled_pairs", int(engine.spilled_rows))
    del holder  # the doc column was consumed by the writer
    return DistributedResult(
        counts=None, top=top, n_keys=n_keys, records=records,
        n_pairs=n_pairs, flag_rounds=flag_rounds, flag_s=flag_s,
        resumed_chunks=resumed)


def partition_output_path(output_path: str, proc: int, n_proc: int) -> str:
    """``<output>.part<p>of<P>``: self-describing, no manifest needed."""
    return f"{output_path}.part{proc}of{n_proc}"


@dataclass
class DistributedResult:
    """Replicated result of a multi-process run, identical on every
    process.  ``top`` carries resolved key bytes when any process's
    dictionary knows them."""

    counts: "dict[int, int] | None"   # wordcount/bigram: hash -> count
    top: "list[tuple[int, bytes | None, int]]"  # (hash, bytes?, value)
    n_keys: int
    records: int                      # THIS process's mapped records
    n_pairs: int = 0                  # invertedindex only
    estimate: float = 0.0             # distinct only
    centroids: "np.ndarray | None" = None  # kmeans only (replicated)
    flag_rounds: int = 0              # lockstep psum rounds paid
    flag_s: float = 0.0               # ... and their total wall-clock
    resumed_chunks: int = 0           # chunks replayed from checkpoint
    metrics: "dict | None" = None     # THIS process's registry summary
    trace: "list | None" = None       # THIS process's Chrome events


def _local_chunks(config: JobConfig, proc: int, n_proc: int, doc_mode: bool,
                  skip: int = 0):
    """Yield ``(global_index, chunk, base_offset)`` for this process's
    chunks (``index % P == proc``), skipping the first ``skip`` OWNED
    chunks (checkpoint resume).  Every process walks the same chunk
    sequence; a chunk it does not own costs a read, not a map."""
    from map_oxidize_tpu_torch.io.splitter import (
        iter_chunks,
        iter_doc_chunks,
        plan_chunks,
    )

    _, chunk_bytes = plan_chunks(config.input_path, config.chunk_bytes)
    it = (iter_doc_chunks(config.input_path, chunk_bytes) if doc_mode
          else iter_chunks(config.input_path, chunk_bytes))
    owned = 0
    off = 0
    for i, chunk in enumerate(it):
        base = off
        off += len(chunk)
        if i % n_proc != proc:
            continue
        owned += 1
        if owned <= skip:
            continue
        yield i, chunk, base


def run_distributed_job(config: JobConfig, workload: str
                        ) -> DistributedResult:
    """Multi-process job runner (JAX ``run_distributed_job`` :898): every
    process maps its chunk subset (``index % P == process_id``), feeds the
    global mesh in lockstep and returns a replicated
    :class:`DistributedResult`.

    Workloads: ``wordcount`` / ``bigram`` (fold engine),
    ``invertedindex`` (collect engine), ``distinct`` (local HLL registers,
    one max-merge allgather), ``kmeans`` (``dist_device``), and ``sort`` /
    ``join`` / ``sessionize`` (:mod:`.dataflow`).  With
    ``config.checkpoint_dir`` each process spills its mapped chunks under
    ``<dir>/proc_<id>`` and resumes its own prefix.

    The process group is started here from ``config.dist_coordinator``
    when it is not up yet.  The remote-staged transport runs first and
    needs none: its processes coordinate through the shared filesystem
    only, so their identity comes from ``dist_num_processes`` /
    ``dist_process_id``.  Each process writes a trace/metrics shard
    (``<path>.proc<i>``), process 0 merges them at job end, and an abort
    passes through the flight recorder first."""
    from map_oxidize_tpu_torch.parallel.mesh import process_slot

    config.validate()
    proc, n_proc = process_slot()
    if n_proc == 1 and config.dist_num_processes > 1:
        n_proc = config.dist_num_processes
        proc = max(config.dist_process_id, 0)
    cap = int(config.collect_max_rows or 0) or (1 << 27)
    if resolve_transport(config, cap) == "remote" and n_proc > 1:
        if workload not in ("wordcount", "bigram"):
            raise ValueError(
                "the remote shuffle transport supports fold workloads "
                f"(wordcount, bigram), not {workload!r}")
        obs = Obs.from_config(config, process=proc, n_processes=n_proc)
        with obs.recording(config, workload):
            return _run_remote_staged(config, workload, obs, proc, n_proc)
    if config.dist_coordinator:
        init_distributed(config.dist_coordinator, config.dist_num_processes,
                         config.dist_process_id)
    proc, n_proc = process_slot()
    obs = Obs.from_config(config, process=proc, n_processes=n_proc)
    wire0 = dict(WIRE)
    with obs.recording(config, workload):
        if workload == "distinct":
            r = _run_distributed_distinct(config, obs)
        elif workload == "kmeans":
            r = _run_distributed_kmeans(config, obs)
        elif workload in ("sort", "join", "sessionize"):
            from map_oxidize_tpu_torch.parallel.dataflow import (
                run_distributed_dataflow,
            )

            r = run_distributed_dataflow(config, workload, obs)
        else:
            r = _run_distributed_core(config, workload, obs)
    # the wire is the port's own (host-staged Gloo), so it is logged, not
    # a metric key
    _log.info("process %d sent %d bytes to its peers over Gloo in %d "
              "calls", proc, WIRE["bytes"] - wire0["bytes"],
              WIRE["calls"] - wire0["calls"])
    return r


def _run_distributed_core(config: JobConfig, workload: str, obs: Obs
                          ) -> DistributedResult:
    from map_oxidize_tpu_torch.obs import dataplane as _dp
    from map_oxidize_tpu_torch.ops.hashing import HashDictionary
    from map_oxidize_tpu_torch.runtime import resolve_mapper
    from map_oxidize_tpu_torch.runtime.driver import (
        collect_engine_kw,
        solved_exchange,
    )
    from map_oxidize_tpu_torch.shuffle.pipelined import (
        COMBINABLE,
        combine_map_output,
        record_push_combine,
    )
    from map_oxidize_tpu_torch.workloads.bigram import make_bigram
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    registry = obs.registry
    use_native = resolve_mapper(config, workload) == "native"
    doc_mode = workload == "invertedindex"
    cap = int(config.collect_max_rows or 0) or (1 << 27)
    transport = resolve_transport(
        config, cap, name=obs.knob("shuffle_transport",
                                   config.shuffle_transport))
    push_mode = transport == "pipelined"
    exchange = solved_exchange(config, obs)
    reducer = None
    if workload == "wordcount":
        mapper, reducer = make_wordcount(config.tokenizer, use_native)
        engine = DistributedReduceEngine(config, reducer,
                                         exchange_method=exchange)
    elif workload == "bigram":
        mapper, reducer = make_bigram(config.tokenizer, use_native)
        engine = DistributedReduceEngine(config, reducer,
                                         exchange_method=exchange)
    elif workload == "invertedindex":
        from map_oxidize_tpu_torch.workloads.inverted_index import (
            make_inverted_index,
        )

        mapper = make_inverted_index(config.tokenizer, config.use_native)
        engine = DistributedCollectEngine(config, transport=transport,
                                          exchange_method=exchange,
                                          **collect_engine_kw(config))
    else:
        raise ValueError(f"unknown distributed workload {workload!r}")
    engine.obs = obs
    if getattr(engine, "transport", None):
        registry.set("shuffle/transport", engine.transport)
    elif push_mode:
        registry.set("shuffle/transport", "pipelined")
    P_ = engine.n_proc
    dictionary = HashDictionary()
    # data-plane audit over the GLOBAL shard partition: every process
    # digests the rows it maps; the in-side vectors allgather-reduce at
    # finalize
    dp = obs.ensure_dataplane(
        engine.S,
        conserves=(not doc_mode and reducer.combine == "sum"
                   and getattr(mapper, "conserves_counts", True)))

    # per-process checkpoint substore: chunk ownership is part of the job
    # identity (a resume under another process count would replay chunks
    # this process no longer owns)
    ckpt = None
    staged_outs: list = []
    staged = 0
    records = 0
    resumed = 0
    if config.checkpoint_dir:
        from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore

        ckpt = CheckpointStore(
            os.path.join(config.checkpoint_dir, f"proc_{engine.proc}"),
            CheckpointStore.job_meta(config, workload, extra={
                "dist_processes": P_,
                "dist_process_id": engine.proc,
            }),
            registry=registry)
    vals_dtype = np.uint32 if doc_mode else np.int32

    def _produce():
        """This process's MapOutputs: the checkpointed prefix first
        (lazily), then freshly mapped chunks, spilled as they come."""
        nonlocal resumed
        replayed = 0
        if ckpt is not None:
            for _idx, out, _off in ckpt.replay():
                out.ensure_planes()
                replayed += 1
                yield out
            resumed = replayed
            if replayed:
                _log.info("process %d resumed %d checkpointed chunks",
                          engine.proc, replayed)
        save_at = replayed
        for idx, chunk, base in _local_chunks(config, engine.proc, P_,
                                              doc_mode, replayed):
            with obs.tracer.span("dist/map_chunk", index=idx,
                                 bytes=len(chunk)):
                if doc_mode:
                    out = mapper.map_docs(chunk, base)
                else:
                    out = mapper.map_chunk(bytes(chunk))
                out.ensure_planes()
            if ckpt is not None:
                ckpt.save(save_at, out, base + len(chunk))
                save_at += 1
            if obs.heartbeat is not None:
                obs.heartbeat.update(rows=out.records_in,
                                     bytes_done=base + len(chunk))
            yield out

    # push cadence: under the pipelined transport the map runs ahead of
    # the lockstep exchange on the prefetch thread
    if push_mode:
        from map_oxidize_tpu_torch.runtime.pipeline import pipelined

        source = iter(pipelined(
            _produce(),
            max(2, int(obs.knob("pipeline_depth", config.pipeline_depth))),
            obs, name="push",
            ratio_gauge="pipeline/shuffle_overlap_ratio"))
    else:
        source = _produce()

    # map-side combiner: the audit digests the RAW rows first (its
    # checksums are sum-combine-invariant)
    do_combine = (not doc_mode
                  and config.push_combine != "off"
                  and (config.push_combine == "on" or push_mode)
                  and reducer.combine in COMBINABLE)

    def _window():
        hi = np.concatenate([o.hi for o in staged_outs])
        lo = np.concatenate([o.lo for o in staged_outs])
        va = np.concatenate([np.asarray(o.values) for o in staged_outs])
        return hi, lo, va

    def _pop_block():
        nonlocal staged
        if staged_outs:
            hi, lo, va = _window()
        else:
            hi = np.empty(0, np.uint32)
            lo = np.empty(0, np.uint32)
            va = np.empty((0, 2) if doc_mode else 0, vals_dtype)
        if do_combine and hi.shape[0]:
            win = MapOutput(hi=hi, lo=lo, values=va, records_in=0)
            win, c_in, c_out = combine_map_output(win, reducer.combine)
            if c_out < c_in:  # identity windows recount nothing
                record_push_combine(obs, c_in, c_out)
                hi, lo = win.hi, win.lo
                va = np.asarray(win.values)
        take = min(engine.local_rows, hi.shape[0])
        staged_outs[:] = [MapOutput(hi=hi[take:], lo=lo[take:],
                                    values=va[take:], records_in=0)]
        staged = hi.shape[0] - take
        return hi[:take], lo[:take], va[:take]

    exhausted = False
    flag_rounds = 0
    flag_s = 0.0
    with obs.phase("map+reduce"):
        while True:
            while not exhausted and staged < engine.local_rows:
                try:
                    out = next(source)
                except StopIteration:
                    exhausted = True
                    break
                dictionary.update(out.dictionary)
                records += out.records_in
                if dp is not None and len(out):
                    rows = _dp.map_output_rows(out, pairs=doc_mode)
                    if rows is not None:
                        (dp.record_pairs_in if doc_mode
                         else dp.record_fold_in)(*rows)
                staged_outs.append(out)
                staged += len(out)
                if do_combine and staged >= engine.local_rows:
                    # collapse the staged window: if duplicates fold away
                    # the loop keeps pulling, so the block that travels
                    # carries up to local_rows DISTINCT keys
                    hi, lo, va = _window()
                    win = MapOutput(hi=hi, lo=lo, values=va, records_in=0)
                    win, c_in, c_out = combine_map_output(
                        win, reducer.combine)
                    if c_out < c_in:
                        record_push_combine(obs, c_in, c_out)
                        staged_outs[:] = [win]
                        staged = c_out
            have = staged > 0
            t0 = time.perf_counter()
            # round= is the lockstep sequence tag the critical path joins
            # the processes' barrier spans on
            with obs.tracer.span("dist/lockstep_flag", round=flag_rounds):
                if doc_mode:
                    cont = engine.any_remaining(
                        have, rows=min(staged, engine.local_rows))
                else:
                    cont = engine.any_remaining(have)
            flag_s += time.perf_counter() - t0
            flag_rounds += 1
            if not cont:
                break
            blk = _pop_block()
            if push_mode:
                registry.count("shuffle/push_rounds")
                registry.count("shuffle/push_rows", int(blk[0].shape[0]))
            with obs.tracer.span("dist/merge_local",
                                 rows=int(blk[0].shape[0]),
                                 round=flag_rounds - 1):
                engine.merge_local(*blk)

    if doc_mode and engine.spilled:
        result = _spilled_invertedindex_result(
            config, obs, engine, dictionary, records=records,
            flag_rounds=flag_rounds, flag_s=flag_s, resumed=resumed)
    elif doc_mode:
        result = _collect_result(config, obs, engine, dictionary, dp,
                                 records, flag_rounds, flag_s, resumed)
    else:
        result = _fold_result(config, obs, engine, dictionary, dp,
                              records, flag_rounds, flag_s, resumed)
    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)
    registry.set("records_in", records)
    registry.set("flag_rounds", flag_rounds)
    registry.set("device_rows_fed", engine.rows_fed)
    result.metrics, result.trace = finish_distributed_obs(obs, config,
                                                          workload)
    _log.info("distributed %s: %d processes, %d local records, %d keys, "
              "%d lockstep flag rounds (%.3fs)", workload, P_, records,
              result.n_keys, flag_rounds, flag_s)
    return result


def _collect_result(config, obs, engine, dictionary, dp, records,
                    flag_rounds, flag_s, resumed) -> DistributedResult:
    """The resident inverted index's finalize: the replicated global pair
    set, per-term doc counts from its sorted runs, the top-k, and this
    process's ``h % P`` postings partition."""
    registry = obs.registry
    P_ = engine.n_proc
    with obs.phase("finalize"):
        keys, docs = engine.finalize()
    if dp is not None:
        dp.set_records_in(records)
        dp.reduce_distributed(
            lambda v: _allgather_u64(v, obs, "dist/dataplane"))
        # finalize() gathered the full global pair set on every process:
        # the out-side is recorded once, after the reduction
        dp.record_pairs_out(keys, docs)
        dp.resolve_hot_keys(
            gather_strings(dp.hot_hashes(), dictionary, obs).get)
        dp.check_pairs()
    # per-term doc counts (term segments are disjoint across shards, so
    # run lengths are the global df)
    if keys.shape[0]:
        bounds = np.flatnonzero(
            np.concatenate([[True], keys[1:] != keys[:-1]]))
        df = np.diff(np.append(bounds, keys.shape[0]))
        uniq = keys[bounds]
    else:
        uniq = np.empty(0, np.uint64)
        df = np.empty(0, np.int64)
        bounds = np.empty(0, np.int64)
    order = np.lexsort((uniq, -df))[:config.top_k]
    t_hashes = uniq[order].tolist()
    words = gather_strings(t_hashes, dictionary, obs)
    top = [(h, words.get(h), int(df[order][j]))
           for j, h in enumerate(t_hashes)]
    if config.output_path:
        from map_oxidize_tpu_torch.io.writer import write_postings_stream

        with obs.phase("write"):
            names = partition_strings(uniq.tolist(), dictionary,
                                      engine.proc, P_, obs)
            ends = np.append(bounds, keys.shape[0])
            owned = sorted(
                (names[int(h)], j) for j, h in enumerate(uniq.tolist())
                if int(h) % P_ == engine.proc)  # term-byte output order
            n_terms, n_bytes = write_postings_stream(
                partition_output_path(config.output_path, engine.proc, P_),
                ((term, np.sort(docs[ends[j]:ends[j + 1]]))
                 for term, j in owned))
        registry.count("dist/partition_terms_written", n_terms)
        registry.count("dist/partition_bytes_written", n_bytes)
    return DistributedResult(
        counts=None, top=top, n_keys=int(uniq.shape[0]), records=records,
        n_pairs=int(keys.shape[0]), flag_rounds=flag_rounds, flag_s=flag_s,
        resumed_chunks=resumed)


def _fold_result(config, obs, engine, dictionary, dp, records,
                 flag_rounds, flag_s, resumed) -> DistributedResult:
    """The fold engine's finalize: the replicated counts, the top-k with
    its strings, and this process's ``h % P`` output partition."""
    from map_oxidize_tpu_torch.ops.hashing import join_u64

    with obs.phase("finalize"):
        hi, lo, vals, n = engine.finalize()
    live = ~((hi == np.uint32(SENTINEL)) & (lo == np.uint32(SENTINEL)))
    k64 = join_u64(hi[live], lo[live])
    if k64.shape[0] != n:
        raise RuntimeError(f"{k64.shape[0]} live keys vs n_unique {n}")
    if dp is not None:
        dp.set_records_in(records)
        dp.reduce_distributed(
            lambda v: _allgather_u64(v, obs, "dist/dataplane"))
        # the readback is replicated: recorded after the reduction, so it
        # is never summed across P
        dp.record_fold_out(k64, vals[live])
        dp.resolve_hot_keys(
            gather_strings(dp.hot_hashes(), dictionary, obs).get)
        dp.check_fold()
    counts = dict(zip(k64.tolist(), vals[live].tolist()))
    if len(counts) != n:
        raise RuntimeError(
            f"engine emitted duplicate live keys: {n} rows, "
            f"{len(counts)} distinct")
    t_hi, t_lo, t_vals = engine.top_k(config.top_k)
    t64 = join_u64(t_hi, t_lo)
    tlive = t64 != np.uint64(0xFFFFFFFFFFFFFFFF)
    t_hashes = t64[tlive].tolist()
    words = gather_strings(t_hashes, dictionary, obs)
    top = [(h, words.get(h), c)
           for h, c in zip(t_hashes, t_vals[tlive].tolist())]
    if config.output_path:
        from map_oxidize_tpu_torch.io.writer import write_final_result

        with obs.phase("write"):
            names = partition_strings(list(counts), dictionary,
                                      engine.proc, engine.n_proc, obs)
            write_final_result(
                partition_output_path(config.output_path, engine.proc,
                                      engine.n_proc),
                ((b, counts[h]) for h, b in names.items()))
    return DistributedResult(
        counts=counts, top=top, n_keys=n, records=records,
        flag_rounds=flag_rounds, flag_s=flag_s, resumed_chunks=resumed)


def _run_remote_staged(config: JobConfig, workload: str, obs: Obs,
                       proc: int, n_proc: int) -> DistributedResult:
    """Fold workloads over the remote-staged transport (JAX :1339): map +
    map-side combine + stage to the shared filesystem, then a
    collective-free drain.  No lockstep loop: every cross-process edge is
    a manifest, so a peer SIGKILLed mid-shuffle cannot wedge this process.
    After staging, each process waits (``remote_stage_timeout_s``) for its
    peers' ``final`` manifests; a peer that never goes final is claimed by
    exactly one survivor, which re-maps the chunks missing from the dead
    peer's last committed manifest into a recovery stage.  Every process
    then drains every partition, checks each against the manifest-summed
    weighted checksum, and writes the output partitions it is responsible
    for (its own, plus any dead peer's it claimed)."""
    from map_oxidize_tpu_torch.obs.dataplane import ConservationError, mix64
    from map_oxidize_tpu_torch.ops.hashing import HashDictionary, join_u64
    from map_oxidize_tpu_torch.runtime import resolve_mapper
    from map_oxidize_tpu_torch.shuffle.pipelined import (
        COMBINABLE,
        combine_map_output,
        record_push_combine,
    )
    from map_oxidize_tpu_torch.shuffle.remote import (
        RemoteStage,
        claim_dead_proc,
        read_manifest,
        read_partition,
        read_strings,
        stage_root,
        wait_for_finals,
    )
    from map_oxidize_tpu_torch.workloads.bigram import make_bigram
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    registry = obs.registry
    registry.set("shuffle/transport", "remote")
    use_native = resolve_mapper(config, workload) == "native"
    maker = make_wordcount if workload == "wordcount" else make_bigram
    mapper, reducer = maker(config.tokenizer, use_native)
    ufunc = COMBINABLE[reducer.combine]
    do_combine = (config.push_combine != "off"
                  and reducer.combine in COMBINABLE)
    root = stage_root(config)
    os.makedirs(root, exist_ok=True)

    def _stage_owned(owner: int, skip_chunks: "set[int]",
                     stage: RemoteStage) -> "tuple[HashDictionary, int]":
        """Map + combine + stage every chunk ``owner`` owns that is not
        already manifest-committed."""
        dictionary = HashDictionary()
        records = 0
        for idx, chunk, base in _local_chunks(config, owner, n_proc,
                                              False, 0):
            if idx in skip_chunks:
                continue
            with obs.tracer.span("dist/map_chunk", index=idx,
                                 bytes=len(chunk)):
                out = mapper.map_chunk(bytes(chunk))
                out.ensure_planes()
            dictionary.update(out.dictionary)
            records += out.records_in
            if do_combine and len(out):
                out, c_in, c_out = combine_map_output(out, reducer.combine)
                record_push_combine(obs, c_in, c_out)
            k64 = (out.keys64 if out.keys64 is not None
                   else join_u64(out.hi, out.lo))
            va = (np.ones(len(out), np.int64) if out.values is None
                  else np.asarray(out.values))
            with obs.tracer.span("shuffle/remote_stage", index=idx,
                                 rows=int(k64.shape[0])):
                # strings BEFORE the chunk commit: a committed chunk's
                # keys must resolve even if this process dies next
                stage.stage_strings(out.dictionary)
                stage.append_chunk(idx, k64, va, records=out.records_in)
            if obs.heartbeat is not None:
                obs.heartbeat.update(rows=out.records_in,
                                     bytes_done=base + len(chunk))
        stage.finish()
        return dictionary, records

    with obs.phase("map+stage"):
        _, records = _stage_owned(proc, set(),
                                  RemoteStage(root, proc, n_proc, obs=obs))

    # the filesystem rendezvous: peers' final manifests, or takeover
    responsible = {proc}
    with obs.phase("stage_wait"):
        manifests, dead = wait_for_finals(
            root, n_proc, proc, config.remote_stage_timeout_s)
    manifests[proc] = read_manifest(root, proc)
    for d in dead:
        if claim_dead_proc(root, d, proc):
            _log.warning("process %d claimed dead peer %d: re-mapping "
                         "its un-staged chunks", proc, d)
            registry.count("shuffle/remote_takeovers")
            done = set((manifests.get(d) or {}).get("chunks_done", ()))
            with obs.phase("recover"):
                _stage_owned(d, done, RemoteStage(root, proc, n_proc,
                                                  obs=obs, owner=d))
            responsible.add(d)
        else:
            # another survivor won the claim: wait for ITS recovery
            # manifest to go final (its re-mapped rows feed every
            # partition, ours included)
            deadline = (time.monotonic()
                        + max(config.remote_stage_timeout_s, 1.0))
            while True:
                rec = read_manifest(root, d, recovery=True)
                if rec is not None and rec.get("final"):
                    break
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"peer {d} died and its claimant never finished "
                        "recovery within the stage timeout")
                time.sleep(0.25)
    for d in dead:
        rec = read_manifest(root, d, recovery=True)
        if rec is not None:
            manifests[n_proc + d] = rec  # a distinct key; drains sum all

    # collective-free drain: every partition, checksum-verified
    counts: dict = {}
    with obs.phase("drain+reduce"):
        for q in range(n_proc):
            keys, vals, want = read_partition(root, manifests, q)
            if keys.shape[0]:
                order = np.argsort(keys, kind="stable")
                ks, vs = keys[order], vals[order]
                bounds = np.flatnonzero(
                    np.concatenate([[True], ks[1:] != ks[:-1]]))
                uniq = ks[bounds]
                folded = ufunc.reduceat(vs, bounds)
                got = int((mix64(uniq) * folded.view(np.uint64))
                          .sum(dtype=np.uint64))
            else:
                uniq = np.empty(0, np.uint64)
                folded = np.empty(0, np.int64)
                got = 0
            if got != want:
                raise ConservationError(
                    f"remote-staged partition {q} drained checksum "
                    f"{got:#x} != manifest sum {want:#x}: staged rows "
                    "were lost or duplicated")
            registry.count("shuffle/remote_partitions_drained")
            counts.update(zip(uniq.tolist(),
                              (int(v) for v in folded.tolist())))
    words = read_strings(root)
    order = sorted(counts, key=lambda h: (-counts[h], h))[:config.top_k]
    top = [(h, words.get(h), counts[h]) for h in order]

    if config.output_path:
        from map_oxidize_tpu_torch.io.writer import write_final_result

        with obs.phase("write"):
            for q in sorted(responsible):
                owned = sorted(
                    (words[h], h) for h in counts
                    if h % n_proc == q and h in words)
                write_final_result(
                    partition_output_path(config.output_path, q, n_proc),
                    ((b, counts[h]) for b, h in owned))
    # the stage directory stays: peers drain at their own pace, and after
    # a takeover it is the recovery evidence
    registry.set("records_in", records)
    registry.set("flag_rounds", 0)
    result = DistributedResult(
        counts=counts, top=top, n_keys=len(counts), records=records)
    result.metrics, result.trace = finish_distributed_obs(obs, config,
                                                          workload)
    _log.info("remote-staged %s: process %d/%d, %d local records, "
              "%d global keys, %d dead peers recovered", workload, proc,
              n_proc, records, len(counts), len(dead))
    return result


def finish_distributed_obs(obs: Obs, config: JobConfig, workload: str
                           ) -> "tuple[dict, list | None]":
    """The multi-process twin of ``Obs.finish`` (JAX :1528): final
    watermarks, the per-process metrics document
    (``<metrics_out>.proc<i>``), the trace shard (``<trace_out>.proc<i>``,
    :data:`~map_oxidize_tpu_torch.obs.merge.SHARD_SCHEMA`), a shard
    barrier, process 0's merge (one Chrome trace + skew report + the
    critical path) and process 0's ledger append.  One process delegates
    to ``Obs.finish`` outright."""
    if obs.n_processes <= 1:
        return obs.finish(config, workload)

    from map_oxidize_tpu_torch.obs import attrib as _attrib
    from map_oxidize_tpu_torch.obs import write_json_atomic
    from map_oxidize_tpu_torch.obs.metrics import (
        sample_device_memory,
        sample_host_memory,
    )

    obs.stop_live()
    xprof_report = obs.finish_xprof()
    # each process's own wall decomposition (collective_wait carries its
    # lockstep share)
    attrib_doc = _attrib.finalize(
        obs, xprof_report, max(time.time() - obs.tracer.wall_start, 1e-9))
    if obs.plan is not None:
        from map_oxidize_tpu_torch.obs import plan as _plan

        try:
            _plan.finalize(obs, obs.plan, attrib_doc)
        except Exception:  # scoring is evidence, never a job failure
            pass
    corpus_bytes = 0.0
    try:
        corpus_bytes = float(os.path.getsize(config.input_path))
    except (OSError, TypeError):
        pass
    # every process merges its own comms rows; only process 0 adds the
    # workload wall curve, so the job counts once
    obs._merge_calibration(
        xprof_report, workload=workload if obs.process == 0 else None,
        corpus_bytes=corpus_bytes, attrib_doc=attrib_doc)
    sample_host_memory(obs.registry)
    sample_device_memory(obs.registry)
    if obs.heartbeat is not None:
        obs.heartbeat.final_beat()
    P_ = obs.n_processes
    data_doc = obs.finish_dataplane()
    meta = obs.stamp(config, workload)
    metrics_doc = dict(obs.registry.to_dict(), meta=meta,
                       attrib=attrib_doc)
    if obs.plan is not None:
        metrics_doc["plan"] = obs.plan
    if data_doc is not None:
        metrics_doc["data"] = data_doc
    if xprof_report is not None:
        metrics_doc["xprof"] = xprof_report
    if obs.series is not None:
        metrics_doc["series"] = obs.series.export()
    if config.metrics_out:
        write_json_atomic(f"{config.metrics_out}.proc{obs.process}",
                          metrics_doc)
    trace = obs.tracer.chrome_trace() if obs.tracer.enabled else None
    if trace is not None:
        trace.insert(0, {"name": "moxt_meta", "ph": "M",
                         "pid": obs.tracer._pid, "tid": 0, "args": meta})
    skew = None
    if trace is not None and config.trace_out and config.trace_out != "-":
        from map_oxidize_tpu_torch.obs.merge import shard_path, write_shard

        write_shard(shard_path(config.trace_out, obs.process), meta,
                    trace, metrics_doc)
        # rendezvous so process 0 reads only written shards; best effort:
        # a peer that died after its last engine collective fails it, and
        # this process's shard, outputs and metrics are already on disk
        try:
            barrier(_default_mesh())
            if obs.process == 0:
                from map_oxidize_tpu_torch.obs import merge as obs_merge

                skew = obs_merge.maybe_merge_at_job_end(config, 0, P_)
        except Exception as e:  # evidence must not fail the job
            _log.warning("obs shard barrier/merge failed (%s); merge by "
                         "hand: python -m map_oxidize_tpu_torch obs merge "
                         "%s", e, config.trace_out)
    critpath_doc = (skew or {}).get("critpath")
    if critpath_doc and not critpath_doc.get("error"):
        from map_oxidize_tpu_torch.obs import critpath as _critpath

        _critpath.publish(obs.registry, critpath_doc)
        if config.metrics_out:
            metrics_doc["critpath"] = critpath_doc
            metrics_doc["gauges"] = dict(
                metrics_doc.get("gauges") or {},
                **_critpath.headline(critpath_doc))
            write_json_atomic(f"{config.metrics_out}.proc{obs.process}",
                              metrics_doc)
        try:
            if obs.series is not None:
                obs.series.sample_once()
            if obs.alerts is not None:
                obs.alerts.evaluate_once()
        except Exception:  # evidence, never a job failure
            pass
    summary = obs.registry.summary()
    if obs.process == 0 and config.ledger_dir:
        from map_oxidize_tpu_torch.obs import ledger

        extra: dict = {}
        if skew:
            extra = {"records_total": skew.get("records_total"),
                     "skew": skew.get("skew")}
        if obs.plan is not None:
            extra["plan"] = obs.plan
        if critpath_doc and not critpath_doc.get("error"):
            extra["critpath"] = {
                "bound_by": critpath_doc.get("bound_by"),
                "path_over_wall_pct":
                    critpath_doc.get("path_over_wall_pct"),
                "blame": critpath_doc.get("blame"),
                "slack": critpath_doc.get("slack"),
                "what_if": critpath_doc.get("what_if"),
            }
        comms = obs.registry.comms_table()
        if comms:
            extra["comms"] = comms
        if data_doc is not None:
            from map_oxidize_tpu_torch.obs.dataplane import ledger_section

            extra["data"] = ledger_section(data_doc)
        ledger.append(config.ledger_dir, ledger.build_entry(
            config, workload, summary, n_processes=P_, extra=extra))
    return summary, trace


def _run_distributed_distinct(config: JobConfig, obs: Obs
                              ) -> DistributedResult:
    """Distributed HLL (JAX :1715): each process folds its chunks into
    local registers; ONE allgather max-merges them (registers are a max
    monoid: the merge is exact, the estimate is the union's)."""
    from map_oxidize_tpu_torch.workloads.distinct import (
        DistinctMapper,
        hll_estimate,
    )

    mesh = _default_mesh()
    proc, n_proc = mesh.process, mesh.n_processes
    p = config.hll_precision
    registers = np.zeros(1 << p, np.int32)
    records = 0
    if config.checkpoint_dir:
        _log.warning("--checkpoint-dir has no effect on distributed "
                     "distinct: registers are tiny and the scan restarts "
                     "cheaply; no spill is written")
    mapper = DistinctMapper(config.tokenizer, config.use_native, p)
    with obs.phase("map+reduce"):
        for i, chunk, base in _local_chunks(config, proc, n_proc, False):
            with obs.tracer.span("dist/map_chunk", index=i,
                                 bytes=len(chunk)):
                out = mapper.map_chunk(bytes(chunk))
            np.maximum.at(registers, np.asarray(out.lo, np.int64),
                          np.asarray(out.values, np.int32))
            records += out.records_in
            if obs.heartbeat is not None:
                obs.heartbeat.update(rows=out.records_in,
                                     bytes_done=base + len(chunk))
    with obs.phase("finalize"):
        t0 = time.perf_counter()
        all_regs = process_allgather(mesh, registers)
        obs.registry.comm(
            "all_gather", "dist/hll_registers",
            all_regs.shape[0] ** 2 * registers.nbytes,
            shape=registers.shape,
            latency_ms=(time.perf_counter() - t0) * 1e3)
        merged = all_regs.max(axis=0).astype(np.int32)
        est = hll_estimate(merged)
    if config.output_path and proc == 0:
        # merged registers are replicated: one writer, and the file is the
        # single-process driver's byte for byte
        from map_oxidize_tpu_torch.workloads.distinct import (
            write_distinct_output,
        )

        with obs.phase("write"):
            write_distinct_output(config.output_path, merged, float(est), p)
    obs.registry.set("records_in", records)
    obs.registry.set("registers_filled", int(np.count_nonzero(merged)))
    result = DistributedResult(counts=None, top=[], n_keys=0,
                               records=records, estimate=float(est))
    result.metrics, result.trace = finish_distributed_obs(obs, config,
                                                          "distinct")
    return result


def _run_distributed_kmeans(config: JobConfig, obs: Obs
                            ) -> DistributedResult:
    """Multi-process k-means (JAX :1779), ``kmeans_mode`` ``dist_device``:
    the port's sharded fit (:mod:`.kmeans`) over a mesh whose S slots are
    dealt S/P to each process.  Each process loads only its local shards'
    rows of the ``.npy`` (a memory map; the input must be visible to every
    process), each local shard runs the fused ``kmeans_assign_sum`` on its
    block, and the one ``(k, d+1)`` psum per iteration gathers the S
    partials and adds them in global shard order: the centroids are
    bit-equal to the one-process S-slot fit and replicated.  Process 0
    writes ``--output`` and, with ``checkpoint_dir`` (shared storage, like
    the input), the per-iteration snapshot every process resumes."""
    import hashlib

    from map_oxidize_tpu_torch.parallel.kmeans import fit_sharded
    from map_oxidize_tpu_torch.parallel.mesh import shard_bounds
    from map_oxidize_tpu_torch.workloads.kmeans import _fetch

    mesh = make_mesh(config.num_shards, config.backend)
    proc, n_proc, S = mesh.process, mesh.n_processes, mesh.size
    pts = np.load(config.input_path, mmap_mode="r")
    if pts.ndim != 2:
        raise ValueError(f"k-means input must be (n, d); got {pts.shape}")
    n, d = pts.shape
    k = config.kmeans_k
    if n < k:
        raise ValueError(
            f"k-means needs at least kmeans_k={k} points; input has {n}")
    # deterministic init: the first k points (the single-process driver's)
    centroids = np.asarray(pts[:k], np.float32)

    store = None
    start_iter = 0
    if config.checkpoint_dir:
        from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore

        meta = CheckpointStore.job_meta(config, "kmeans", extra={
            "kmeans_k": k,
            "kmeans_mode": "dist_device",
            "kmeans_shards": S,
            "dist_processes": n_proc,
            "kmeans_backend": config.backend,
            "kmeans_precision": config.kmeans_precision,
            "kmeans_init": hashlib.sha256(
                centroids.tobytes()).hexdigest()[:16],
        })
        if proc == 0:
            # process 0 alone arbitrates identity (and clears a stale
            # snapshot); the others wait, then read
            store = CheckpointStore(config.checkpoint_dir, meta)
        barrier(mesh)
        if proc != 0:
            store = CheckpointStore(config.checkpoint_dir, meta)
        snap = store.load_snapshot()
        if snap is not None:
            state, _d, start_iter, _nc, _x = snap
            centroids = np.asarray(state["centroids"], np.float32)
        its = process_allgather(mesh, np.array([start_iter], np.int32)
                                ).reshape(-1)
        if its.size and its.min() != its.max():
            raise RuntimeError(
                f"distributed kmeans resume diverged: processes loaded "
                f"iterations {its.tolist()} — --checkpoint-dir must be on "
                "storage shared by every process")
        if start_iter:
            _log.info("distributed k-means resumed at iteration %d",
                      start_iter)
    bounds = shard_bounds(n, S)
    take = 0
    remaining = config.kmeans_iters - start_iter
    with obs.phase("transfer"):
        # this process's local slots: global shards offset .. offset+L-1
        p = []
        for i, dev in enumerate(mesh.devices):
            lo, hi = bounds[mesh.global_index(i)]
            block = torch.from_numpy(np.array(pts[lo:hi], np.float32))
            if config.kmeans_precision == "bf16":
                block = block.to(torch.bfloat16)  # round to nearest even
            p.append(block.to(dev))
            take += hi - lo
        for dev in set(mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    c = mesh.replicate(torch.from_numpy(centroids).to(mesh.devices[0]))
    precision = config.kmeans_precision
    with obs.phase("iterate"):
        if remaining <= 0:
            # the snapshot covers every requested iteration: it IS the
            # result (the single-process continue-training read)
            if remaining < 0:
                _log.warning(
                    "checkpoint has %d iterations, more than the %d "
                    "requested; returning the snapshotted state",
                    start_iter, config.kmeans_iters)
            out = centroids
        elif store is not None:
            # one iteration per call: only the replicated centroids cross
            # back for process 0's snapshot
            from map_oxidize_tpu_torch.ops.hashing import HashDictionary

            for i in range(remaining):
                c = fit_sharded(mesh, p, c, k, 1, precision)
                done = start_iter + i + 1
                c_np = _fetch(c[0])
                if proc == 0:
                    store.save_snapshot({"centroids": c_np},
                                        HashDictionary(), done, done)
                if obs.heartbeat is not None:
                    obs.heartbeat.update(
                        rows=int(take),
                        fraction=min(done / config.kmeans_iters, 1.0))
            out = c_np
        else:
            out = _fetch(fit_sharded(mesh, p, c, k, remaining,
                                     precision)[0])
    if config.output_path and proc == 0:
        from map_oxidize_tpu_torch.workloads.kmeans import write_centroids

        with obs.phase("write"):
            write_centroids(config.output_path, out)
    ran_iters = max(remaining, 0)
    # comms: one (k, d+1) partials psum per iteration run (the fit's only
    # cross-process traffic: centroids, not points)
    for _ in range(ran_iters):
        obs.registry.comm("psum", "kmeans/fit_sharded",
                          S * k * (d + 1) * 4, shape=(k, d + 1))
    if store is not None and proc == 0:
        # a zero-work run only READ the continue-training state
        store.finish(config.keep_intermediates or ran_iters == 0)
    _log.info("distributed kmeans: %d processes, %d points, k=%d, %d "
              "iterations (%d resumed)", n_proc, n, k,
              start_iter + ran_iters, start_iter)
    obs.registry.set("records_in", int(take) * ran_iters)
    obs.registry.set("points", int(n))
    obs.registry.set("iters", start_iter + ran_iters)
    if start_iter:
        obs.registry.set("resumed_iters", start_iter)
    result = DistributedResult(counts=None, top=[], n_keys=0,
                               records=int(take) * ran_iters,
                               centroids=np.asarray(out, np.float32))
    result.metrics, result.trace = finish_distributed_obs(obs, config,
                                                          "kmeans")
    return result


def run_distributed_wordcount(config: JobConfig, workload: str = "wordcount"):
    """Back-compat wrapper: ``(counts, top)`` with hash-keyed top pairs."""
    r = run_distributed_job(config, workload)
    return r.counts, [(h, c) for h, _w, c in r.top]


__all__ = [
    "DistributedCollectEngine",
    "DistributedReduceEngine",
    "DistributedResult",
    "GROUP_TIMEOUT_S",
    "gather_strings",
    "init_distributed",
    "partition_output_path",
    "partition_strings",
    "resolve_strings_for",
    "run_distributed_job",
    "run_distributed_wordcount",
    "shutdown_distributed",
]
