"""Host collect-reduce engine: the wide-key-space counterpart of the device
fold (a copy of the JAX package's ``runtime/host_reduce.py``:
``HostCollectReduceEngine`` :47, with its spill at the cap,
``_count_unique``, ``_reduce_kv`` and ``top_k``).

The streaming fold (:class:`~map_oxidize_tpu_torch.runtime.engine.DeviceReduceEngine`)
is built for key spaces far smaller than the token stream.  A *wide* key
space (bigram: ~|V|^2 distinct keys approaching the pair count) inverts
that trade: the accumulator grows through many capacities, and the fold
re-sorts capacity + batch rows per merge, O(batches * total log total)
against one O(total log total) sort.  So for wide keys the formulation is
collect-then-reduce-once: ``np.sort`` (or the native radix) +
``reduceat``, behind the same ``feed / finalize / top_k`` surface the
drivers use.  The device fold stays available through
``reduce_mode='fold'``.  Numpy only; nothing here touches the card.
"""

from __future__ import annotations

import numpy as np

from map_oxidize_tpu_torch.api import MapOutput, Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.ops.hashing import join_u64, split_u64
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

_UFUNC = {"sum": np.add, "min": np.minimum, "max": np.maximum}


class HostCollectReduceEngine:
    """Collects (key, value) rows on the host; one vectorized sort +
    segment-``reduceat`` at finalize.

    Scalar values only (the wide-key workloads are count-shaped); vector
    values keep the fold engine.  ``max_rows`` bounds RESIDENT host
    memory: any job that crosses it switches to an external-memory
    partition (top-bits disk buckets, reduced bucket-by-bucket at
    finalize — see ``_begin_spill``) instead of aborting.  Hash-only sum
    rows spill as bare 8-byte keys; explicit-value rows (any combine)
    spill as 12-byte (key, value) records, and one bucket may hold both
    flavours (a sum job can mix implicit-ones and pre-combined blocks).
    """

    #: disk-bucket count for the beyond-RAM path: top 8 key bits (the
    #: shared scheme — see runtime/spill.py for the partition rationale).
    SPILL_BUCKETS_BITS = 8

    #: shards: one (the sharded engines set the mesh's)
    S = 1

    def __init__(self, config: JobConfig, reducer: Reducer,
                 value_shape: tuple = (), value_dtype=np.int32,
                 max_rows: int = 1 << 28, transport: str | None = None):
        from map_oxidize_tpu_torch.shuffle import make_transport, resolve_transport

        if tuple(value_shape) != ():
            raise ValueError("HostCollectReduceEngine takes scalar values; "
                             "use the fold engine for vector reduces")
        if reducer.combine not in _UFUNC:
            raise ValueError(f"unknown combine {reducer.combine!r}")
        self.config = config
        self.combine = reducer.combine
        self.value_dtype = np.dtype(value_dtype)
        self.max_rows = max_rows
        #: placement policy (map_oxidize_tpu_torch.shuffle): hybrid = today's
        #: spill-past-the-cap, disk = buckets from the first row, hbm =
        #: strictly resident (the cap raises).  Callers that applied the
        #: planner's knob (Obs.knob seam) pass the resolved name.
        self.transport = (transport if transport is not None
                          else resolve_transport(config, max_rows))
        self._transport = make_transport(self.transport)
        self._buckets_opened: set = set()
        self.rows_fed = 0
        self._keys: list[np.ndarray] = []   # u64 blocks
        self._vals: list[np.ndarray] = []
        self._reduced: tuple | None = None
        # external-memory spill state (hash-only count jobs past max_rows)
        self._staged_rows = 0
        self.peak_staged_rows = 0           # observability + test oracle
        self.obs = None                     # obs.Obs injected by the driver
        self._spill = None                  # runtime.spill.BucketFiles
        self.spilled_rows = 0

    @property
    def spilled(self) -> bool:
        return self._spill is not None or self.spilled_rows > 0

    # the capacity hint is a no-op: there is no device accumulator to
    # size, and distinct keys are discovered by the one final sort
    def hint_total_keys(self, n: int) -> None:
        pass

    def feed(self, out: MapOutput) -> None:
        n = len(out)
        self.rows_fed += n
        if n == 0:
            return
        if out.docs64 is not None:
            raise ValueError(
                "pair-shaped MapOutput (docs64) fed to the scalar "
                "HostCollectReduceEngine; pair outputs take CollectEngine")
        k64 = out.keys64 if out.keys64 is not None else join_u64(out.hi, out.lo)
        vals = (None if out.values is None
                else np.asarray(out.values, self.value_dtype))
        if self._spill is not None:
            self._spill_block(k64, vals)
            return
        self._keys.append(k64)
        # None = implicit all-ones (the hash-only compact form): no 136MB of
        # ones to allocate, concatenate, and re-scan at finalize
        self._vals.append(vals)
        self._staged_rows += n
        self.peak_staged_rows = max(self.peak_staged_rows, self._staged_rows)
        action = self._transport.admit(
            self.rows_fed, self.max_rows,
            "host collect-reduce (HostCollectReduceEngine)")
        if action in ("demote", "spill"):
            # 'push' (pipelined, under the cap) stays resident: the
            # eager-merge cadence is the driver's half of the seam
            self._begin_spill(demote=action == "demote")

    def flush(self) -> None:  # feed is already host-resident
        pass

    # --- external-memory partition (beyond-RAM count jobs) ---------------

    def _begin_spill(self, demote: bool = True) -> None:
        """Switch to disk-bucket staging (the shared top-bits partition,
        :mod:`runtime.spill`): every staged block routes to per-bucket
        files, then all further feeds go the same way.  Resident memory
        drops to the per-feed block plus OS write buffers; finalize
        reduces one ~1/256th bucket at a time (buckets are top-bit
        ranges, so bucket-by-bucket output concatenates into the globally
        ascending order every caller already expects).  ``demote`` marks
        a mid-job trip at the cap (hybrid) vs the disk transport's
        from-row-0 staging; only the former records the shared
        ``shuffle/demote`` evidence."""
        import contextlib

        from map_oxidize_tpu_torch.runtime.spill import BucketFiles
        from map_oxidize_tpu_torch.shuffle import record_demotion

        self._spill = BucketFiles("moxt_spill_", self.SPILL_BUCKETS_BITS)
        _log.info(
            "host collect %s; staging in %d disk buckets under %s",
            f"crossed max_rows={self.max_rows}" if demote
            else "runs the disk transport",
            1 << self.SPILL_BUCKETS_BITS, self._spill.path)
        span = (record_demotion(self.obs, self._staged_rows, "ram", "disk",
                                max_rows=self.max_rows)
                if demote else contextlib.nullcontext())
        with span:
            if self.obs is not None:
                self.obs.registry.count("spill/begin_events")
                self.obs.tracer.instant("host_reduce/spill_begin",
                                        max_rows=self.max_rows,
                                        rows_fed=self.rows_fed)
            blocks, vals_list = self._keys, self._vals
            self._keys = self._vals = None
            self._staged_rows = 0
            for k64, v in zip(blocks, vals_list):
                self._spill_block(k64, v)

    def _kv_dtype(self) -> np.dtype:
        return np.dtype([("k", "<u8"), ("v", self.value_dtype.str)])

    def _spill_block(self, k64: np.ndarray, vals=None) -> None:
        from map_oxidize_tpu_torch.runtime.spill import partition_top_bits

        # a sum block of explicit all-ones is the hash-only flavour — keep
        # the 8B/row format for it (wordcount/bigram checkpoint replays
        # re-feed their ones explicitly)
        if vals is not None and self.combine == "sum" and bool(
                np.all(vals == 1)):
            vals = None
        elif vals is None and self.combine != "sum":
            # the in-RAM reduce treats values=None as ones for EVERY
            # combine; materialize the same ones here so a min/max job
            # with implicit blocks spills instead of crashing mid-feed
            vals = np.ones(k64.shape[0], self.value_dtype)
        order, counts, offs = partition_top_bits(
            k64, self.SPILL_BUCKETS_BITS)
        if vals is None:
            self._spill.write_partitioned("u64", k64[order], counts, offs)
            spilled_bytes = int(k64.nbytes)
        else:
            rec = np.empty(k64.shape[0], self._kv_dtype())
            rec["k"] = k64[order]
            rec["v"] = vals[order]
            self._spill.write_partitioned("kv", rec, counts, offs)
            spilled_bytes = int(rec.nbytes)
        self.spilled_rows += int(k64.shape[0])
        from map_oxidize_tpu_torch.shuffle.disk import record_spill

        record_spill(self.obs, self._buckets_opened, counts,
                     int(k64.shape[0]), spilled_bytes)

    @staticmethod
    def _segment_bounds(keys_sorted: np.ndarray) -> np.ndarray:
        """Start index of each equal-key run in a sorted key array."""
        return np.flatnonzero(np.concatenate(
            [[True], keys_sorted[1:] != keys_sorted[:-1]]))

    def _count_unique(self, blocks: "list[np.ndarray]") -> tuple:
        """(uniq ascending, counts) of the concatenation of u64 ``blocks``
        where every row weighs 1 — counts are run lengths.  Two native
        formulations, chosen by key-space shape: the fused MSD +
        in-cache-LSD unique+count moves less memory and suits mostly
        UNIQUE keys; duplicate-heavy keys (Zipf bigrams) suit the plain
        LSD sort, whose scatter gains write locality from equal-key runs.
        A 64k stride sample (across blocks) picks the side; the
        duplicate-heavy sort consumes the blocks IN PLACE
        (sort_u64_blocks: its first radix pass is the concatenation);
        np.unique serves when the job asked for no native code
        (``use_native=False``).  ``blocks`` is consumed (the caller must
        drop its own references)."""
        from map_oxidize_tpu_torch.native.build import (
            count_u64_or_none,
            sort_kd_or_none,
            sort_u64_blocks_or_none,
        )

        uniq = counts = None
        keys = None
        n_rows = int(sum(b.shape[0] for b in blocks))
        if self.config.use_native and n_rows > (1 << 20):
            stride = max(n_rows // 65536, 1)
            samp = np.concatenate([b[::stride] for b in blocks])
            if np.unique(samp).shape[0] >= 0.98 * samp.shape[0]:
                keys = np.concatenate(blocks)
                blocks = None
                uc = count_u64_or_none(keys)
                if uc is not None:
                    uniq, counts = uc
        if uniq is None and blocks is not None and self.config.use_native:
            sorted_keys = sort_u64_blocks_or_none(blocks)
            if sorted_keys is not None:
                blocks = None
                bounds = self._segment_bounds(sorted_keys)
                counts = np.diff(np.append(bounds, sorted_keys.shape[0]))
                uniq = sorted_keys[bounds]
        if uniq is None:
            if keys is None:
                keys = np.concatenate(blocks)
                blocks = None
            if self.config.use_native and sort_kd_or_none(keys, None):
                bounds = self._segment_bounds(keys)
                counts = np.diff(np.append(bounds, keys.shape[0]))
                uniq = keys[bounds]
            else:
                uniq, counts = np.unique(keys, return_counts=True)
        if counts.shape[0] and int(counts.max()) > np.iinfo(
                self.value_dtype).max:
            # beyond-RAM jobs can push one hot key past int32: keep the
            # wide dtype (correct counts) rather than silently wrapping
            _log.info("a key's count exceeds %s; returning int64 counts",
                      self.value_dtype)
            return uniq, counts.astype(np.int64, copy=False)
        return uniq, counts.astype(self.value_dtype, copy=False)

    def _reduce_spilled(self) -> tuple:
        """Bucket-by-bucket reduce of the disk partition: bucket i holds
        exactly the keys with top bits == i, so per-bucket (uniq, vals)
        concatenate into the same globally ascending result the in-RAM
        path produces — no cross-bucket merge exists to do.  A bucket may
        hold hash-only rows (weight 1), (key, value) records, or both
        (sum jobs mixing implicit-ones and pre-combined blocks): the
        hash-only-only case keeps the fused native unique+count; mixed
        and kv-only buckets take the sort + ``reduceat`` route with the
        combine ufunc."""
        uniq_parts: list = []
        val_parts: list = []
        for i in range(1 << self.SPILL_BUCKETS_BITS):
            plain = self._spill.take("u64", i, np.uint64)
            rec = self._spill.take("kv", i, self._kv_dtype())
            if plain is None and rec is None:
                continue
            if rec is None:
                u, c = self._count_unique([plain])
            else:
                keys_list = [np.ascontiguousarray(rec["k"])]
                vals_list = [np.ascontiguousarray(rec["v"])]
                if plain is not None:
                    keys_list.append(plain)
                    vals_list.append(np.ones(plain.shape[0],
                                             self.value_dtype))
                del rec
                u, c = self._reduce_kv(np.concatenate(keys_list)
                                       if len(keys_list) > 1
                                       else keys_list[0],
                                       np.concatenate(vals_list)
                                       if len(vals_list) > 1
                                       else vals_list[0])
            uniq_parts.append(u)
            val_parts.append(c)
        self._spill.cleanup()
        self._spill = None  # spilled stays observable via spilled_rows
        if not uniq_parts:
            return (np.empty(0, np.uint64), np.empty(0, self.value_dtype))
        return (np.concatenate(uniq_parts), np.concatenate(val_parts))

    def _reduce_kv(self, keys: np.ndarray, vals: np.ndarray) -> tuple:
        """Sort + segment-``reduceat`` of one bucket's explicit-value rows
        (sum accumulates int64 with the same overflow escape the in-RAM
        path documents; min/max keep value_dtype)."""
        from map_oxidize_tpu_torch.native.build import sort_kd_or_none

        vals64 = vals.astype(np.int64)
        if not (self.config.use_native and sort_kd_or_none(keys, vals64)):
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            vals64 = vals64[order]
        bounds = self._segment_bounds(keys)
        red = _UFUNC[self.combine].reduceat(
            vals64 if self.combine == "sum"
            else vals64.astype(self.value_dtype), bounds)
        uniq = keys[bounds]
        if red.dtype != self.value_dtype:
            info = np.iinfo(self.value_dtype)
            if (int(red.max(initial=0)) > info.max
                    or int(red.min(initial=0)) < info.min):
                _log.info("a key's sum exceeds %s; returning int64 "
                          "values", self.value_dtype)
            else:
                red = red.astype(self.value_dtype, copy=False)
        return uniq, red

    def _reduce(self) -> tuple:
        if self._reduced is None:
            if self.spilled_rows:
                self._reduced = self._reduce_spilled()
            elif not self._keys:
                e = np.empty(0, np.uint64)
                self._reduced = (e, np.empty(0, self.value_dtype))
            elif self.combine == "sum" and all(
                    v is None or bool(np.all(np.asarray(v) == 1))
                    for v in self._vals):
                blocks = self._keys
                self._keys = self._vals = None  # consumed by _count_unique
                self._reduced = self._count_unique(blocks)
                return self._reduced
            else:
                keys = np.concatenate(self._keys)
                # the comprehension equals plain concatenation when all
                # blocks are explicit; mixed blocks fill in their ones
                vals = np.concatenate(
                    [np.ones(k.shape[0], self.value_dtype)
                     if v is None else v
                     for k, v in zip(self._keys, self._vals)])
                self._keys = self._vals = None  # free the blocks
                order = np.argsort(keys, kind="stable")
                keys = keys[order]
                vals = vals[order]
                bounds = self._segment_bounds(keys)
                red = _UFUNC[self.combine].reduceat(
                    vals.astype(np.int64 if self.combine == "sum"
                                else self.value_dtype), bounds)
                info = np.iinfo(self.value_dtype)
                if (red.dtype != self.value_dtype
                        and (int(red.max(initial=0)) > info.max
                             or int(red.min(initial=0)) < info.min)):
                    # same int64 escape as the spilled/_count_unique paths:
                    # a hot key past value_dtype must not wrap silently
                    # just because the job stayed under max_rows
                    _log.info("a key's sum exceeds %s; returning int64 "
                              "values", self.value_dtype)
                else:
                    red = red.astype(self.value_dtype, copy=False)
                self._reduced = (keys[bounds], red)
        return self._reduced

    def finalize(self):
        """Engine contract: ``(hi, lo, vals, n_unique)``; no padding rows —
        every returned row is live.

        ``vals`` is normally ``value_dtype`` (int32), but a beyond-RAM sum
        job whose hottest key exceeds ``value_dtype``'s range returns
        int64 instead of silently wrapping (logged when it happens) —
        consumers that pack values must check ``vals.dtype``, not assume
        the configured dtype."""
        keys, vals = self._reduce()
        hi, lo = split_u64(keys)
        return hi, lo, vals, int(keys.shape[0])

    def top_k(self, k: int):
        """(hi_k, lo_k, vals_k, n_unique) — count-descending, deterministic
        key-ascending tie-break, mirroring the device engines.  Like
        :meth:`finalize`, ``vals_k`` widens to int64 when a count
        overflows ``value_dtype`` (beyond-RAM hot keys)."""
        keys, vals = self._reduce()
        n = int(keys.shape[0])
        if n == 0:
            e32 = np.empty(0, np.uint32)
            return e32, e32, np.empty(0, self.value_dtype), 0
        from map_oxidize_tpu_torch.ops.topk import top_k_candidate_indices

        k = min(k, n)
        idx = top_k_candidate_indices(vals, k)
        # count desc, key-hash asc on ties (no strings at engine level);
        # int64 negation because -int32.min would overflow
        order = np.lexsort((keys[idx], -vals[idx].astype(np.int64)))
        idx = idx[order[:k]]
        hi, lo = split_u64(keys[idx])
        return hi, lo, vals[idx], n
