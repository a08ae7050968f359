"""Disk transport: beyond-RAM shuffle staging (a copy of the JAX package's
``shuffle/disk.py``: ``DiskTransport``, ``record_spill``,
``DiskPairStage``).

Rows stage in the top-bits disk-bucket partition
(:mod:`map_oxidize_tpu_torch.runtime.spill`) from the FIRST row: resident
memory stays bounded by one fed block plus OS write buffers at any corpus
size, and the bucket-by-bucket drain at finalize yields the globally
key-ascending order downstream consumers expect (buckets are top-bit key
ranges).

:class:`DiskPairStage` is the (key, doc) pair stage of the pair collect
engine's beyond-RAM path — one record format, one obs contract.
"""

from __future__ import annotations

import time

import numpy as np

from map_oxidize_tpu_torch.shuffle.base import ShuffleTransport


class DiskTransport(ShuffleTransport):
    """SPILLED from the start: every block goes to disk buckets."""

    name = "disk"

    def __init__(self) -> None:
        super().__init__()
        self.spilled_state = True

    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        return "spill"


def record_spill(obs, opened: set, counts: np.ndarray, rows: int,
                 nbytes: int) -> None:
    """The one spill-counter record — ``spill/rows``, ``spill/bytes``,
    and ``spill/buckets`` (distinct bucket files opened, tracked through
    the caller's ``opened`` set, which this mutates) — shared by every
    bucket-staging engine so the ledger's spill gate always compares
    like with like.  ``counts`` is the per-bucket row count of the block
    just partitioned (``partition_top_bits``)."""
    new = set(np.flatnonzero(counts).tolist()) - opened
    opened |= new
    if obs is not None:
        reg = obs.registry
        reg.count("spill/rows", rows)
        reg.count("spill/bytes", nbytes)
        if new:
            reg.count("spill/buckets", len(new))


class DiskPairStage:
    """Top-bits disk-bucket staging of 16-byte (u64 key, i64 doc)
    records — the one on-disk pair format.  Wraps
    :class:`~map_oxidize_tpu_torch.runtime.spill.BucketFiles` with the obs
    contract (``spill/rows``, ``spill/bytes``, ``spill/buckets``) and
    the record codec, so every spilling engine shares both.

    The stable partition preserves feed order within a bucket; drain
    callers choose the final intra-bucket sort (stable-by-key when feed
    order already implies ascending docs, full (key, doc) lexsort when
    rows interleave across processes)."""

    #: on-disk record: the joined u64 key + i64 doc id
    REC = np.dtype([("k", "<u8"), ("d", "<i8")])

    def __init__(self, bits: int | None = None,
                 prefix: str = "moxt_pair_spill_", obs=None):
        from map_oxidize_tpu_torch.runtime.spill import DEFAULT_BITS, BucketFiles

        self.bits = DEFAULT_BITS if bits is None else bits
        self.files = BucketFiles(prefix, self.bits)
        self.obs = obs
        self.rows = 0
        self.bytes = 0
        self._buckets_opened: set[int] = set()
        # spill round-trip conservation: (rows, xor, sum) pair digests
        # of everything staged vs everything drained — the full-drain
        # paths compare them and raise ConservationError on mismatch
        # (obs.dataplane_enabled=False switches the digesting off)
        self._dig_in = [0, 0, 0]
        self._dig_out = [0, 0, 0]
        self._bucket_rows = np.zeros(1 << self.bits, np.int64)

    def _audit_on(self) -> bool:
        return (self.obs is None
                or getattr(self.obs, "dataplane_enabled", True))

    @property
    def n_buckets(self) -> int:
        return 1 << self.bits

    @property
    def path(self) -> str:
        return self.files.path

    def add(self, keys: np.ndarray, docs: np.ndarray) -> None:
        """Partition one (u64 keys, i64 docs) block by top key bits and
        append to the bucket files, recording the spill counters."""
        from map_oxidize_tpu_torch.runtime.spill import partition_top_bits

        n = int(keys.shape[0])
        if n == 0:
            return
        order, counts, offs = partition_top_bits(
            np.asarray(keys, np.uint64), self.bits)
        rec = np.empty(n, self.REC)
        rec["k"] = keys[order]
        rec["d"] = docs[order]
        t0 = time.perf_counter()
        self.files.write_partitioned("kd", rec, counts, offs)
        self._count_io_ms(t0)
        self.rows += n
        self.bytes += int(rec.nbytes)
        self._bucket_rows += counts
        if self._audit_on():
            from map_oxidize_tpu_torch.obs.dataplane import pair_digest

            x, s = pair_digest(keys, docs)
            self._dig_in[0] += n
            self._dig_in[1] ^= x
            self._dig_in[2] = (self._dig_in[2] + s) & 0xFFFFFFFFFFFFFFFF
        record_spill(self.obs, self._buckets_opened, counts, n,
                     int(rec.nbytes))

    def _count_io_ms(self, t0: float) -> None:
        """Feed the attribution ledger's ``spill_io`` bucket: wall spent
        in bucket-file writes/drains (``spill/io_ms``), measured at the
        call sites so partition/sort compute stays out of it."""
        if self.obs is not None:
            self.obs.registry.count(
                "spill/io_ms", (time.perf_counter() - t0) * 1e3)

    def take(self, i: int) -> "np.ndarray | None":
        """Drain bucket ``i`` (read + unlink); None if never written."""
        t0 = time.perf_counter()
        try:
            rec = self.files.take("kd", i, self.REC)
        finally:
            self._count_io_ms(t0)
        if rec is not None and self._audit_on():
            from map_oxidize_tpu_torch.obs.dataplane import pair_digest

            x, s = pair_digest(rec["k"], rec["d"])
            self._dig_out[0] += int(rec.shape[0])
            self._dig_out[1] ^= x
            self._dig_out[2] = (self._dig_out[2] + s) & 0xFFFFFFFFFFFFFFFF
        return rec

    def check_roundtrip(self) -> None:
        """Spill conservation: after a FULL drain, the drained pair
        multiset must digest identically to what was staged.  A mismatch
        means the disk round-trip dropped, duplicated, or corrupted
        records — a named hard failure (:class:`ConservationError`),
        recorded on the run's data-plane audit when one is live."""
        if not self._audit_on():
            return
        dp = (getattr(self.obs, "dataplane", None)
              if self.obs is not None else None)
        if dp is not None:
            dp.checks += 1
        if self._dig_in == self._dig_out:
            return
        from map_oxidize_tpu_torch.obs.dataplane import ConservationError

        msg = (f"spill conservation violated: staged {self._dig_in[0]} "
               f"pair rows (xor {self._dig_in[1]:#018x}, sum "
               f"{self._dig_in[2]:#018x}) but drained {self._dig_out[0]} "
               f"(xor {self._dig_out[1]:#018x}, sum "
               f"{self._dig_out[2]:#018x}) — the disk round-trip lost or "
               f"corrupted records")
        if dp is not None:
            dp.violations.append(msg)
        raise ConservationError(msg)

    def _publish_bucket_skew(self) -> None:
        """Post-drain disk-bucket skew: max/mean rows over the non-empty
        top-bit buckets (``data/spill_bucket_imbalance``) — the
        disk-spill twin of the audit's hash-partition imbalance."""
        if self.obs is None:
            return
        live = self._bucket_rows[self._bucket_rows > 0]
        if live.shape[0]:
            self.obs.registry.set(
                "data/spill_bucket_imbalance",
                round(float(live.max() / live.mean()), 4))

    def drain_csr(self, sort_pairs):
        """Bucket-by-bucket CSR finalize — THE shared drain (the
        single-controller and distributed spilled finalizes differ only
        in ``sort_pairs``, the intra-bucket ``(keys, docs) -> (keys,
        docs)`` sort: stable-by-key where feed order already implies
        ascending docs, full (key, doc) lexsort where rows interleave
        across processes).  Each bucket loads, sorts, appends its doc
        segment to ONE on-disk column, and accumulates distinct
        terms/offsets; buckets are top-bit ranges, so terms come out
        globally hash-ascending.  Returns ``(terms, offsets,
        docs_memmap, holder, peak_rows)`` — ``holder`` keeps the doc
        column alive, ``peak_rows`` is the largest bucket drained
        (bounded-residency evidence).  Consumes the stage."""
        import os

        terms_parts: list = []
        df_parts: list = []
        doc_path = os.path.join(self.path, "docs.i64")
        peak = 0
        dp = (getattr(self.obs, "dataplane", None)
              if self.obs is not None else None)
        with open(doc_path, "wb") as out:
            for i in range(self.n_buckets):
                rec = self.take(i)
                if rec is None:
                    continue
                keys = np.ascontiguousarray(rec["k"])
                docs = np.ascontiguousarray(rec["d"])
                del rec
                peak = max(peak, int(keys.shape[0]))
                keys, docs = sort_pairs(keys, docs)
                if dp is not None:
                    # buckets are disjoint key ranges, so per-bucket
                    # records sum to the exact out-side audit
                    dp.record_pairs_out(keys, docs)
                bounds = (np.flatnonzero(np.concatenate(
                    [[True], keys[1:] != keys[:-1]])) if keys.shape[0]
                    else np.empty(0, np.int64))
                terms_parts.append(keys[bounds])
                df_parts.append(np.diff(np.append(bounds, keys.shape[0])))
                t0 = time.perf_counter()
                out.write(docs.tobytes())
                self._count_io_ms(t0)
        self.check_roundtrip()
        self._publish_bucket_skew()
        holder = self.release()  # caller keeps the doc file alive
        if not terms_parts:
            return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                    np.empty(0, np.int64), holder, peak)
        terms = np.concatenate(terms_parts)
        offsets = np.concatenate(
            [[0], np.cumsum(np.concatenate(df_parts))]).astype(np.int64)
        docs = np.memmap(doc_path, np.int64, mode="r")
        return terms, offsets, docs, holder, peak

    def drain_sorted(self, sort_pairs):
        """Bucket-by-bucket sorted-RUN drain (the total-order sort's
        finalize, CSR-free): yields ``(keys, docs)`` per non-empty
        bucket, each block sorted by ``sort_pairs`` — buckets are
        top-bit key RANGES, so the yielded blocks concatenate into the
        globally key-ascending stream, and a full (key, doc) lexsort
        per bucket makes that concatenation the exact total order.
        Resident memory: one bucket at a time.  Consumes the stage
        (bucket files unlink as they drain; the temp dir is removed
        when the generator finishes)."""
        try:
            for i in range(self.n_buckets):
                rec = self.take(i)
                if rec is None:
                    continue
                keys = np.ascontiguousarray(rec["k"])
                docs = np.ascontiguousarray(rec["d"])
                del rec
                yield sort_pairs(keys, docs)
            # only a COMPLETED drain proves conservation (an abandoned
            # generator legitimately leaves staged rows behind)
            self.check_roundtrip()
            self._publish_bucket_skew()
        finally:
            self.cleanup()

    def release(self):
        """Hand the temp directory to the caller (keeps on-disk finalize
        artifacts like the CSR doc column alive)."""
        return self.files.release()

    def cleanup(self) -> None:
        self.files.cleanup()
