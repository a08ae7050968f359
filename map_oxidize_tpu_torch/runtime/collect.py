"""CollectEngine: the variable-length-value reduce (the port of the JAX
package's ``runtime/collect.py``: ``_sort_pairs`` :43, ``CollectEngine``
:51).

Word count's reduce is a monoid fold — values stay fixed-size, so an
accumulator of reduced rows works (runtime/engine.py).  Inverted-index
postings are the opposite: the "reduce" is list concatenation and the
per-key result size is unbounded.  So the engine collects ALL (key, doc)
rows, then sorts them ONCE by (key, doc) at finalize, after which each
key's postings list is a contiguous, internally sorted segment; segment
boundaries fall out of a vectorized key-change scan on the host.

Two sort placements behind one surface (``config.collect_sort``):

* ``'host'`` (the 'auto' default, as in the JAX package): pairs stay in
  host RAM and the one sort is the native radix (or numpy's stable sort).
* ``'device'``: each feed ships packed ``(4, B)`` blocks of 32-bit planes
  (key_hi, key_lo, doc_hi, doc_lo), padded with SENTINEL, to the device;
  finalize concatenates them there, runs :func:`sort_pairs` — the torch
  form of the JAX package's ``lax.sort(num_keys=4)`` — and makes ONE
  blocking fetch of the sorted pairs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from map_oxidize_tpu_torch.api import MapOutput
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import observe_device_wait
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.ops.segment_reduce import (
    keys_from_plane_tensors,
    plane_tensors_from_keys,
)
from map_oxidize_tpu_torch.runtime.engine import next_pow2, pick_device
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


def sort_pairs(stacked: torch.Tensor) -> torch.Tensor:
    """Sort a ``(4, N)`` int32 block of uint32 bit patterns (key_hi,
    key_lo, doc_hi, doc_lo) lexicographically over all four planes, each
    compared UNSIGNED — bit-equal to the JAX package's ``_sort_pairs``
    (``lax.sort`` with ``num_keys=4``).

    The planes join into two 64-bit order columns (key, doc); a stable
    sort by doc, then a stable sort by key over that order, gives the
    (key, doc) order.  Rows equal in all four planes are
    indistinguishable, so stability needs no further tie rule."""
    key = keys_from_plane_tensors(stacked[0], stacked[1])
    doc = keys_from_plane_tensors(stacked[2], stacked[3])
    doc, order = torch.sort(doc, stable=True)
    key = key[order]
    key, order = torch.sort(key, stable=True)
    doc = doc[order]
    khi, klo = plane_tensors_from_keys(key)
    dhi, dlo = plane_tensors_from_keys(doc)
    return torch.stack([khi, klo, dhi, dlo])


@observed("collect/sort")
def sort_pairs_observed(stacked: torch.Tensor) -> torch.Tensor:
    """:func:`sort_pairs` under the launch ledger (JAX
    ``runtime/collect.py:41``), looked up at each call."""
    return sort_pairs(stacked)


class CollectEngine:
    """Append-only collection of (key, doc) pairs + one final sort.

    ``max_rows`` bounds RESIDENT memory; what happens at the cap is the
    shuffle transport's policy (``config.shuffle_transport``,
    :mod:`map_oxidize_tpu_torch.shuffle`): ``hybrid`` (the ``auto``
    default in the resident regime) switches to an external-memory
    partition (top-bits disk buckets of 16-byte (key, doc) records, staged
    through :class:`~map_oxidize_tpu_torch.shuffle.disk.DiskPairStage`),
    ``disk`` stages there from the FIRST row, and ``hbm`` aborts loudly.
    A spilled finalize streams one ~1/256th bucket at a time into a CSR
    whose doc column is a disk memmap.  Device-sort mode keeps the hard
    cap: the device cannot spill without becoming the host path."""

    #: disk-bucket count for the beyond-RAM path: top 8 key bits (the
    #: shared scheme — see runtime/spill.py)
    SPILL_BUCKETS_BITS = 8

    #: shards: one (the sharded engines set the mesh's)
    S = 1

    def __init__(self, config: JobConfig, device=None,
                 max_rows: int = 1 << 27, sort_mode: str | None = None,
                 transport: str | None = None, pair_order: str = "stable"):
        from map_oxidize_tpu_torch.shuffle import (
            make_transport,
            resolve_transport,
        )

        self.config = config
        #: host finalize sort discipline: ``"stable"`` = stable-by-key
        #: (feed order already implies ascending docs per key — the
        #: inverted-index contract), ``"lex"`` = full (key, doc) order with
        #: the doc compared UNSIGNED (payloads are arbitrary u64 bit
        #: patterns).  The device sort is always the full (key, doc) order.
        if pair_order not in ("stable", "lex"):
            raise ValueError(f"pair_order must be stable|lex, "
                             f"got {pair_order!r}")
        self.pair_order = pair_order
        self.sort_mode = sort_mode if sort_mode is not None else (
            "host" if config.collect_sort == "auto" else config.collect_sort)
        self.device = None
        if self.sort_mode == "device":
            self.device = (torch.device(device) if device is not None
                           else pick_device(config.backend))
        self.feed_batch = config.batch_size
        self.max_rows = max_rows
        self.transport = (transport if transport is not None
                          else resolve_transport(config, max_rows))
        if (self.transport in ("disk", "remote")
                and self.sort_mode == "device"):
            if config.shuffle_transport in ("disk", "remote"):
                raise ValueError(
                    f"shuffle_transport={config.shuffle_transport!r} "
                    "stages rows in host disk buckets, which "
                    "collect_sort='device' (a device-resident sort) cannot "
                    "consume; use collect_sort host/auto")
            # an AUTO-routed disk falls back to the resident policy the
            # device sort can honour
            _log.info("auto-routed shuffle_transport='disk' does not "
                      "apply to collect_sort='device' (the device cannot "
                      "spill); keeping the resident path")
            self.transport = "hybrid"
        self._transport = make_transport(self.transport)
        self._batches: list = []   # device (4, B) int32 blocks
        self._batch_rows: list[int] = []  # live rows per block
        self._stage: list = []
        self._staged = 0
        self.rows_fed = 0
        self.peak_staged_rows = 0           # observability + test oracle
        self.obs = None                     # obs.Obs injected by the driver
        self._spill = None                  # shuffle.disk.DiskPairStage
        self.spilled_rows = 0

    @property
    def spilled(self) -> bool:
        return self._spill is not None or self.spilled_rows > 0

    def feed(self, out: MapOutput) -> None:
        n = len(out)
        self.rows_fed += n
        if n == 0:
            return
        if (self.sort_mode == "host" and out.keys64 is not None
                and out.docs64 is not None):
            # compact pair form: consumed as-is by the host finalize
            self._stage.append(("c", out.keys64, out.docs64))
        else:
            out.ensure_planes()  # no-op except for compact outputs
            vals = out.values
            if (vals.ndim != 2 or vals.shape[1] != 2
                    or vals.dtype != np.uint32):
                raise ValueError(
                    "CollectEngine expects (n, 2) uint32 doc planes")
            self._stage.append(("p", out.hi, out.lo, vals))
        self._staged += n
        self.peak_staged_rows = max(self.peak_staged_rows, self._staged)
        if self._spill is not None:
            # already spilling: route the fresh block straight to disk
            self._spill_pairs(*self._host_columns()[:2])
            return
        if self.sort_mode == "host":
            action = self._transport.admit(self.rows_fed, self.max_rows,
                                           "pair collect (CollectEngine)")
            if action in ("demote", "spill"):
                # 'demote' drains what staged residently, 'spill' (disk)
                # starts with nothing staged; 'push' stays resident — the
                # push cadence is the driver's half
                self._begin_spill(demote=action == "demote")
        elif self.rows_fed > self.max_rows:
            raise RuntimeError(
                f"CollectEngine exceeded max_rows={self.max_rows} in "
                "device-sort mode (the device cannot spill); re-run with "
                "--collect-sort host --shuffle-transport disk|hybrid, "
                "which stages past the cap in disk buckets, or raise "
                "--collect-max-rows if the rows genuinely fit")
        if self.sort_mode == "device" and self._staged >= self.feed_batch:
            self.flush()

    # --- external-memory partition (beyond-RAM pair jobs) ------------------

    def _begin_spill(self, demote: bool = True) -> None:
        """Switch to disk-bucket staging (16-byte (key, doc) records in
        top-bit buckets, so bucket-by-bucket output is globally
        key-ascending; the stable partition keeps feed order within each
        bucket).  ``demote`` marks a mid-job RESIDENT->SPILLED trip (hybrid
        at the cap) vs the disk transport's from-row-0 staging; only the
        former records the ``shuffle/demote`` evidence."""
        import contextlib

        from map_oxidize_tpu_torch.shuffle import (
            DiskPairStage,
            record_demotion,
        )

        self._spill = DiskPairStage(self.SPILL_BUCKETS_BITS,
                                    "moxt_pair_spill_", obs=self.obs)
        _log.info(
            "pair collect %s; staging in %d disk buckets under %s",
            f"crossed max_rows={self.max_rows}" if demote
            else "runs the disk transport",
            1 << self.SPILL_BUCKETS_BITS, self._spill.path)
        span = (record_demotion(self.obs, self._staged, "ram", "disk",
                                max_rows=self.max_rows)
                if demote else contextlib.nullcontext())
        with span:
            if self.obs is not None:
                self.obs.registry.count("spill/begin_events")
                self.obs.tracer.instant("collect/spill_begin",
                                        max_rows=self.max_rows,
                                        rows_fed=self.rows_fed)
            keys, docs, _owned = self._host_columns()
            self._spill_pairs(keys, docs)

    def _spill_pairs(self, keys: np.ndarray, docs: np.ndarray) -> None:
        self._spill.add(keys, docs)
        self.spilled_rows = self._spill.rows

    def finalize_spilled_csr(self):
        """Bucket-by-bucket CSR finalize for spilled runs (the shared
        :meth:`~map_oxidize_tpu_torch.shuffle.disk.DiskPairStage.drain_csr`
        with this engine's host sort).  Returns ``(terms, offsets,
        docs_memmap, holder)`` — terms globally hash-ascending, the doc
        column a read-only memmap, ``holder`` the temp directory keeping
        it alive.  Resident memory: terms/offsets plus one bucket."""
        if self._spill is None:
            raise RuntimeError("finalize_spilled_csr on an unspilled "
                               "engine; use finalize/finalize_csr")
        terms, offsets, docs, holder, _peak = self._spill.drain_csr(
            self._sorted_host_pairs)
        self._spill = None
        return terms, offsets, docs, holder

    def finalize_spilled_runs(self):
        """Sorted-RUN finalize for spilled runs: yields ``(keys, docs)``
        blocks, one per non-empty disk bucket, each sorted by this
        engine's ``pair_order``; concatenated they are globally
        key-ascending.  Resident memory: one bucket.  Consumes the
        stage."""
        if self._spill is None:
            raise RuntimeError("finalize_spilled_runs on an unspilled "
                               "engine; use finalize")
        spill, self._spill = self._spill, None
        return spill.drain_sorted(self._sorted_host_pairs)

    def flush(self) -> None:
        """Device-sort mode: pack the staged rows into ``(4, B)`` blocks
        of uint32 bit patterns (B a power of two, at least 512, at most
        ``batch_size``), SENTINEL-padded, and copy each to the device."""
        if self.sort_mode == "host" or not self._staged:
            return
        hi = np.concatenate([s[1] for s in self._stage])
        lo = np.concatenate([s[2] for s in self._stage])
        vals = np.concatenate([s[3] for s in self._stage])
        self._stage = []
        self._staged = 0
        for start in range(0, hi.shape[0], self.feed_batch):
            stop = min(start + self.feed_batch, hi.shape[0])
            n = stop - start
            b = min(next_pow2(max(n, 512)), self.feed_batch)
            packed = np.full((4, b), SENTINEL, np.uint32)
            packed[0, :n] = hi[start:stop]
            packed[1, :n] = lo[start:stop]
            packed[2, :n] = vals[start:stop, 0]
            packed[3, :n] = vals[start:stop, 1]
            self._batches.append(
                torch.from_numpy(packed.view(np.int32)).to(self.device))
            self._batch_rows.append(n)

    def _host_columns(self):
        """Consume the stage into joined u64 key / i64 doc columns.
        Compact blocks pass through; plane blocks (python mapper,
        checkpoint replay) join here.  Returns ``(keys, docs, owned)`` —
        a single compact block aliases the caller's MapOutput arrays
        (``owned=False``), so in-place consumers must copy first."""
        ks, ds = [], []
        for blk in self._stage:
            if blk[0] == "c":
                ks.append(blk[1])
                ds.append(blk[2])
            else:
                _, hi, lo, v = blk
                ks.append((hi.astype(np.uint64) << np.uint64(32)) | lo)
                ds.append(((v[:, 0].astype(np.uint64) << np.uint64(32))
                           | v[:, 1]).view(np.int64))
        aliased = len(self._stage) == 1 and self._stage[0][0] == "c"
        self._stage, self._staged = [], 0
        if len(ks) == 1:  # single block: no concat copy
            return ks[0], ds[0], not aliased
        return np.concatenate(ks), np.concatenate(ds), True

    def _sorted_host_pairs(self, keys, docs, owned=True):
        """STABLE sort by key alone: rows arrive in ascending doc order per
        term by construction (chunks stream in file order; within a chunk
        the mapper scans documents in line order), so stability alone
        yields (key, doc)-sorted rows.  The native LSD radix carries the
        docs through its scatter; numpy's stable argsort runs when the job
        asked for no native code.

        ``pair_order='lex'`` replaces the stability argument with a full
        (key, doc-as-u64) lexsort."""
        if self.pair_order == "lex":
            order = np.lexsort((docs.view(np.uint64), keys))
            return keys[order], docs[order]
        from map_oxidize_tpu_torch.native.build import sort_kd_or_none

        if self.config.use_native:
            if not owned:
                # the native sort is in-place; never reorder arrays that
                # still alias a caller's MapOutput
                keys, docs = keys.copy(), docs.copy()
            if sort_kd_or_none(keys, docs):
                return keys, docs
        order = np.argsort(keys, kind="stable")
        return keys[order], docs[order]

    def finalize_csr(self, uniq_sorted: np.ndarray | None):
        """CSR finalize ``(terms, offsets, docs_grouped)`` for term spaces
        the map-phase dictionary already enumerates: distinct terms are
        known, so grouping needs no sort (the native hash->dense-id
        group-by, two streaming passes).  Consumes the stage.  Takes the
        sort + boundary scan (the identical CSR) when the native path
        declines or the dictionary does not exactly cover the fed keys;
        returns None only in device-sort mode (the caller uses
        :meth:`finalize`)."""
        if self.sort_mode != "host":
            return None
        if self.spilled:
            raise RuntimeError(
                "engine spilled past max_rows; use finalize_spilled_csr")
        if not self._stage:
            e = np.empty(0, np.uint64)
            return e, np.zeros(1, np.int64), np.empty(0, np.int64)
        keys, docs, owned = self._host_columns()
        if (uniq_sorted is not None and self.config.use_native
                and uniq_sorted.shape[0] <= max(keys.shape[0] // 8, 1)):
            from map_oxidize_tpu_torch.native.build import (
                group_by_key_or_none,
            )

            got = group_by_key_or_none(keys, docs, uniq_sorted)
            if got is not None:
                offsets, grouped = got
                df = np.diff(offsets)
                if not bool(np.all(df > 0)):
                    # dictionary superset (e.g. replayed chunks whose rows
                    # were deduplicated away): drop zero-count terms so the
                    # CSR matches the sort path exactly
                    live = df > 0
                    uniq_sorted = uniq_sorted[live]
                    offsets = np.concatenate(
                        [[0], np.cumsum(df[live])]).astype(np.int64)
                return uniq_sorted, offsets, grouped
        keys, docs = self._sorted_host_pairs(keys, docs, owned)
        bounds = (np.flatnonzero(np.concatenate(
            [[True], keys[1:] != keys[:-1]])) if keys.shape[0]
            else np.empty(0, np.int64))
        return (keys[bounds],
                np.append(bounds, keys.shape[0]).astype(np.int64), docs)

    def finalize(self):
        """One sort over everything fed; returns host arrays
        ``(keys_u64, docs_i64)`` sorted by (key, doc) with padding dropped.
        In device-sort mode the blocks concatenate and sort on the device
        and the live prefix comes back in one blocking fetch
        (``device/compute_ms``)."""
        if self.sort_mode == "host":
            if self.spilled:
                raise RuntimeError(
                    "engine spilled past max_rows; use finalize_spilled_csr")
            if not self._stage:
                return np.empty(0, np.uint64), np.empty(0, np.int64)
            keys, docs, owned = self._host_columns()
            return self._sorted_host_pairs(keys, docs, owned)
        self.flush()
        total = sum(self._batch_rows)
        if total == 0:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        stacked = (self._batches[0] if len(self._batches) == 1
                   else torch.cat(self._batches, dim=1))
        self._batches, self._batch_rows = [], []
        out = sort_pairs_observed(stacked)[:, :total]
        del stacked
        t0 = time.perf_counter()
        packed = out.cpu().numpy().view(np.uint32)
        observe_device_wait(t0)
        keys = (packed[0].astype(np.uint64) << np.uint64(32)) | packed[1]
        docs = ((packed[2].astype(np.uint64) << np.uint64(32)) | packed[3]
                ).view(np.int64)
        return keys, docs
