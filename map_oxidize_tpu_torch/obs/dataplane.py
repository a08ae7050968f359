"""Data-plane observatory: row-conservation audits, key-skew telemetry and
reduction-ratio gauges.  The port of the JAX package's ``obs/dataplane.py``
(``mix64`` :80, ``map_output_rows`` :110, ``weighted_checksum`` :133,
``pair_digest`` :144, ``DataPlaneAudit`` :197 with ``record_pairs_in`` /
``record_pairs_out`` :302-:312 and ``check_pairs`` :444,
``ledger_section`` :616, ``render`` :645).

* **conservation audits** — rows counted where the map output enters the
  reduce and where the readback leaves it, per hash partition, with
  order-independent checksums.  Two families, chosen per engine:

  - fold engines (``combine == "sum"``): the **weighted checksum**
    ``sum(mix64(key) * value) mod 2^64``, invariant under sum-combining,
    so pre-combined map rows and the final reduced counts produce the
    SAME digest;
  - pair engines (the collect reduce): the **pair digest** — XOR and
    wrapping sum of ``mix64(key ^ mix64(doc))`` — an exact multiset
    identity over (key, doc) rows.

  A violation raises :class:`ConservationError`.
* **key-skew telemetry** — per-partition row histograms, HLL distinct-key
  estimates, a bounded hot-key top-k, and the imbalance factor (max/mean
  partition rows).
* **reduction-ratio gauges** — rows in vs distinct keys out.

On one device the audit partitions by hash into ``VIRTUAL_PARTITIONS``.
Everything is host-side numpy.  The cross-process reduction (multi-process
drivers) comes with the modules that feed it.
"""
from __future__ import annotations

import numpy as np

from map_oxidize_tpu_torch.workloads.distinct import hll_estimate

#: metrics-document section schema (``doc["data"]``)
DATA_SCHEMA = "moxt-data-v1"

#: single-shard runs still want skew/reduction telemetry: the audit
#: then partitions by hash into this many VIRTUAL partitions (the
#: conservation identities hold under any deterministic key partition)
VIRTUAL_PARTITIONS = 8

#: per-partition HLL precision (2^p int32 registers per partition —
#: ~16KB at p=12; the global estimate is the union/max of the rows)
HLL_P = 12

#: hot-key tracker bounds: keep the top ``HOT_KEYS`` for the doc,
#: tracked through a dict pruned back to ``_HOT_KEEP`` candidates
#: whenever it grows past ``_HOT_CAP`` (space-bounded heavy hitters;
#: counts for keys that never leave the candidate set are exact)
HOT_KEYS = 10
_HOT_KEEP = 1024
_HOT_CAP = 8192

_U64 = np.uint64
_M1 = _U64(0xBF58476D1CE4E5B9)
_M2 = _U64(0x94D049BB133111EB)


class ConservationError(RuntimeError):
    """A row-conservation audit failed: rows (or their checksum) at one
    phase boundary do not match the other side.  Data was dropped,
    duplicated, or corrupted in between — never a tolerable condition,
    so this is a named hard failure (and ``data/conservation_violations``
    records it for the ledger gate even when the run aborts through the
    flight recorder)."""


def mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: a cheap, well-mixed u64 -> u64
    bijection.  Checksums digest ``mix64(key)`` rather than the raw key
    so adjacent key values cannot cancel in the wrapping sum."""
    x = np.asarray(x, _U64).copy()
    x ^= x >> _U64(30)
    x *= _M1
    x ^= x >> _U64(27)
    x *= _M2
    x ^= x >> _U64(31)
    return x


def join_planes(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) u32 planes -> u64 keys (host twin of the device join)."""
    return ((np.asarray(hi, _U64) << _U64(32))
            | np.asarray(lo, _U64))


def partition_of(keys: np.ndarray, n_partitions: int) -> np.ndarray:
    """Owner partition per key: ``(hi ^ lo) % S`` on the u32 planes, the
    JAX package's shuffle partition (``parallel.shuffle.bucket_of``)."""
    keys = np.asarray(keys, _U64)
    hi = (keys >> _U64(32)).astype(np.uint32)
    lo = keys.astype(np.uint32)
    return ((hi ^ lo) % np.uint32(n_partitions)).astype(np.int64)


def map_output_rows(out, pairs: bool = False) -> "tuple | None":
    """Host ``(keys_u64, values | docs_i64)`` view of a ``MapOutput`` in
    either the plane or the compact 64-bit form (compact fold outputs
    carry implicit all-ones counts — the hash-only contract).  ``None``
    for vector-valued fold rows, which have no scalar conservation
    identity (k-means centroids).  ``pairs`` reads a pair output's doc
    ids instead of values."""
    if getattr(out, "keys64", None) is not None:
        k64 = np.asarray(out.keys64, _U64)
    else:
        k64 = join_planes(out.hi, out.lo)
    if pairs:
        if getattr(out, "docs64", None) is not None:
            return k64, np.asarray(out.docs64, np.int64)
        va = np.asarray(out.values)
        return k64, join_planes(va[:, 0], va[:, 1]).view(np.int64)
    if out.values is None:
        return k64, np.ones(k64.shape[0], np.int64)
    va = np.asarray(out.values)
    if va.ndim != 1:
        return None
    return k64, va


def weighted_checksum(keys: np.ndarray, values: np.ndarray) -> int:
    """``sum(mix64(key) * value) mod 2^64`` over the whole block —
    order-independent and invariant under sum-combining (module
    docstring).  The scalar spelling of the per-partition fold-stage
    digest, exposed for tests and ad-hoc tooling."""
    if np.asarray(keys).shape[0] == 0:
        return 0
    v = np.asarray(values, np.int64).astype(_U64)
    return int((mix64(keys) * v).sum(dtype=_U64))


def pair_digest(keys: np.ndarray, docs: np.ndarray) -> "tuple[int, int]":
    """(XOR, wrapping-sum) of ``mix64(key ^ mix64(doc))`` — an exact
    order-independent multiset identity over (key, doc) rows."""
    if np.asarray(keys).shape[0] == 0:
        return 0, 0
    h = mix64(np.asarray(keys, _U64)
              ^ mix64(np.ascontiguousarray(docs, np.int64).view(_U64)))
    return (int(np.bitwise_xor.reduce(h)), int(h.sum(dtype=_U64)))


def _hll_ranks(hashes: np.ndarray, p: int) -> "tuple[np.ndarray, np.ndarray]":
    """(bucket, rank) per hash — the register-update pair of the
    standard HLL sketch (same frexp trick as
    the JAX package's ``workloads.distinct.hll_registers``)."""
    buckets = (hashes >> _U64(64 - p)).astype(np.int64)
    w = (hashes & _U64((1 << (64 - p)) - 1)).astype(np.float64)
    _, exp = np.frexp(w)
    ranks = np.where(w == 0, 64 - p + 1, 64 - p + 1 - exp)
    return buckets, ranks.astype(np.int32)


class _Stage:
    """One phase boundary's per-partition ledger: row/byte counts plus
    the order-independent digests (both families; the checks read the
    one that applies).  ``scope`` (``local`` map-side, ``disjoint``
    per-bucket drains, ``replicated`` readback) is kept for the
    cross-process reduction."""

    __slots__ = ("rows", "bytes", "vsum", "wsum", "xor", "sum",
                 "uniq", "scope")

    def __init__(self, S: int, scope: str):
        self.rows = np.zeros(S, _U64)
        self.bytes = np.zeros(S, _U64)
        self.vsum = np.zeros(S, _U64)
        self.wsum = np.zeros(S, _U64)
        self.xor = np.zeros(S, _U64)
        self.sum = np.zeros(S, _U64)
        self.uniq = np.zeros(S, _U64)
        self.scope = scope


class DataPlaneAudit:
    """The per-job data-plane ledger (reachable as ``obs.dataplane``;
    drivers create it through ``Obs.ensure_dataplane``).  Every record
    call happens on the driver's ingest thread."""

    def __init__(self, n_partitions: int, conserves: bool = True,
                 hll_p: int = HLL_P, top_k: int = HOT_KEYS):
        self.virtual = n_partitions <= 1
        self.S = VIRTUAL_PARTITIONS if self.virtual else int(n_partitions)
        self.conserves = bool(conserves)
        self.p = hll_p
        self.top_k = top_k
        self.stages: "dict[str, _Stage]" = {}
        self.records_in: "int | None" = None
        #: in-side skew state (fed by map-out records)
        self._regs = np.zeros(self.S << hll_p, np.int32)
        self._hot: "dict[int, int]" = {}
        self._hot_resolved: "dict[int, bytes]" = {}
        self.checks = 0
        self.violations: "list[str]" = []

    # --- recording --------------------------------------------------------

    def _stage(self, name: str, scope: str) -> _Stage:
        st = self.stages.get(name)
        if st is None:
            st = self.stages[name] = _Stage(self.S, scope)
        elif st.scope != scope:
            raise ValueError(f"stage {name!r} recorded with scope "
                             f"{scope!r} after {st.scope!r}")
        return st

    def _skew(self, keys: np.ndarray, part: np.ndarray,
              weights: "np.ndarray | None") -> None:
        h = mix64(keys)
        b, r = _hll_ranks(h, self.p)
        np.maximum.at(self._regs, (part << self.p) + b, r)
        uk, inv = np.unique(keys, return_inverse=True)
        cnt = np.bincount(inv, weights=None if weights is None
                          else np.asarray(weights, np.float64))
        hot = self._hot
        for k, c in zip(uk.tolist(), cnt.tolist()):
            hot[k] = hot.get(k, 0) + int(c)
        if len(hot) > _HOT_CAP:
            keep = sorted(hot.items(), key=lambda kv: -kv[1])[:_HOT_KEEP]
            self._hot = dict(keep)

    def _fold(self, name: str, scope: str, keys: np.ndarray,
              values: np.ndarray, skew: bool) -> None:
        keys = np.asarray(keys, _U64)
        n = int(keys.shape[0])
        if n == 0:
            return
        part = partition_of(keys, self.S)
        st = self._stage(name, scope)
        rows = np.bincount(part, minlength=self.S).astype(_U64)
        st.rows += rows
        row_b = _U64((keys.nbytes + np.asarray(values).nbytes) // n)
        st.bytes += rows * row_b
        v = np.asarray(values, np.int64).astype(_U64)
        np.add.at(st.vsum, part, v)
        np.add.at(st.wsum, part, mix64(keys) * v)
        if skew:
            self._skew(keys, part, values)

    def _pairs(self, name: str, scope: str, keys: np.ndarray,
               docs: np.ndarray, skew: bool, uniq: bool) -> None:
        keys = np.asarray(keys, _U64)
        n = int(keys.shape[0])
        if n == 0:
            return
        part = partition_of(keys, self.S)
        st = self._stage(name, scope)
        rows = np.bincount(part, minlength=self.S).astype(_U64)
        st.rows += rows
        st.bytes += rows * _U64(16)  # the one on-disk pair record width
        h = mix64(keys ^ mix64(np.ascontiguousarray(docs, np.int64)
                               .view(_U64)))
        np.bitwise_xor.at(st.xor, part, h)
        np.add.at(st.sum, part, h)
        if uniq:
            uk = np.unique(keys)
            st.uniq += np.bincount(partition_of(uk, self.S),
                                   minlength=self.S).astype(_U64)
        if skew:
            self._skew(keys, part, None)

    def record_fold_in(self, keys, values) -> None:
        """Map output entering the fold shuffle (pre-exchange, possibly
        chunk-pre-combined — the weighted checksum absorbs that)."""
        self._fold("map_out", "local", keys, values, skew=True)

    def record_fold_out(self, keys, values) -> None:
        """The final reduced readback (one distinct key per row)."""
        self._fold("reduce_out", "replicated", keys, values, skew=False)
        self._stage("reduce_out", "replicated").uniq += np.bincount(
            partition_of(np.asarray(keys, _U64), self.S),
            minlength=self.S).astype(_U64)

    def record_pairs_in(self, keys, docs) -> None:
        """(key, doc) pairs entering the collect reduce."""
        self._pairs("map_out", "local", keys, docs, skew=True, uniq=False)

    def record_pairs_out(self, keys, docs) -> None:
        """(key, doc) pairs leaving finalize toward the writer.  Called
        once on the resident path, per disjoint bucket on the spilled
        path (bucket key ranges are disjoint, so per-call distinct
        counts sum exactly)."""
        self._pairs("reduce_out", "disjoint", keys, docs, skew=False,
                    uniq=True)

    def set_records_in(self, records: int) -> None:
        self.records_in = int(records)

    # --- checks -----------------------------------------------------------

    def _violate(self, msg: str) -> None:
        self.violations.append(msg)
        raise ConservationError(msg)

    def check_fold(self) -> None:
        """Per-partition fold conservation: the weighted checksum and
        the value sum at ``map_out`` must equal ``reduce_out`` exactly
        (both are invariant under the sum-combine), and the total value
        sum must equal the mapped record count when the mapper conserves
        counts — the generalized, per-partition spelling of the old
        global driver assertion."""
        a = self.stages.get("map_out")
        b = self.stages.get("reduce_out")
        if a is None or b is None or not self.conserves:
            return
        self.checks += 1
        for p_ in range(self.S):
            if int(a.vsum[p_]) != int(b.vsum[p_]):
                self._violate(
                    f"row conservation violated at map->reduce: partition "
                    f"{p_}: value sum in {int(a.vsum[p_])} != out "
                    f"{int(b.vsum[p_])} (rows in {int(a.rows[p_])}, "
                    f"out {int(b.rows[p_])})")
            if int(a.wsum[p_]) != int(b.wsum[p_]):
                self._violate(
                    f"row conservation violated at map->reduce: partition "
                    f"{p_}: weighted checksum in {int(a.wsum[p_]):#018x} "
                    f"!= out {int(b.wsum[p_]):#018x} with matching value "
                    f"sums — keys were remapped or counts were swapped "
                    f"across keys")
        self.checks += 1
        if self.records_in is not None and self.records_in > 0:
            total = int(a.vsum.sum(dtype=_U64))
            if total != self.records_in:
                self._violate(
                    f"count conservation violated: mapped "
                    f"{self.records_in} records but map output values "
                    f"sum to {total}")

    def check_pairs(self) -> None:
        """Per-partition pair-multiset conservation: rows, XOR, and
        wrapping-sum digests at ``map_out`` must equal ``reduce_out``
        exactly — pairs cross the collect (and any spill round-trip)
        unchanged."""
        a = self.stages.get("map_out")
        b = self.stages.get("reduce_out")
        if a is None or b is None:
            return
        self.checks += 1
        for p_ in range(self.S):
            if int(a.rows[p_]) != int(b.rows[p_]):
                self._violate(
                    f"pair conservation violated at map->reduce: "
                    f"partition {p_}: {int(a.rows[p_])} rows in, "
                    f"{int(b.rows[p_])} out")
            if (int(a.xor[p_]) != int(b.xor[p_])
                    or int(a.sum[p_]) != int(b.sum[p_])):
                self._violate(
                    f"pair conservation violated at map->reduce: "
                    f"partition {p_}: digest in "
                    f"(xor {int(a.xor[p_]):#018x}, sum "
                    f"{int(a.sum[p_]):#018x}) != out "
                    f"(xor {int(b.xor[p_]):#018x}, sum "
                    f"{int(b.sum[p_]):#018x}) with matching row counts "
                    f"— pair contents changed in flight")

    def check_total(self, total) -> None:
        """The consumer-facing readback container must tell the same
        story as the audited arrays: Σ counts (as a consumer will read
        them) == records mapped — the old global driver assertion,
        kept as a named audit check so a corrupted counts container
        aborts through the same flight-recorder path."""
        if not self.conserves or not self.records_in:
            return
        self.checks += 1
        if int(total) != self.records_in:
            self._violate(
                f"count conservation violated: mapped {self.records_in} "
                f"records but reduced counts sum to {int(total)}")

    # --- export -----------------------------------------------------------

    def _skew_figures(self) -> "tuple[np.ndarray, float, np.ndarray]":
        a = self.stages.get("map_out")
        rows = (a.rows.astype(np.float64) if a is not None
                else np.zeros(self.S))
        mean = rows.mean()
        imb = float(rows.max() / mean) if mean > 0 else 1.0
        m = 1 << self.p
        est = np.array([hll_estimate(self._regs[p_ * m:(p_ + 1) * m])
                        if rows[p_] > 0 else 0.0
                        for p_ in range(self.S)])
        return rows, imb, est

    def hot_hashes(self) -> "list[int]":
        """The top-k hot-key hashes (descending rows)."""
        return sorted(self._hot, key=self._hot.get, reverse=True)[
            :self.top_k]

    def resolve_hot_keys(self, lookup) -> None:
        """Best-effort hash -> key-bytes resolution for the hot-key
        table (``lookup(hash) -> bytes | None``, e.g. the run's
        ``HashDictionary``)."""
        for k in self.hot_hashes():
            try:
                b = lookup(k)
            except KeyError:
                b = None
            if b is not None:
                self._hot_resolved[k] = b

    def doc(self) -> dict:
        """The structured audit section (``moxt-data-v1``): the
        per-stage conservation table, the per-partition skew/reduction
        figures, and the hot-key top-k."""
        rows, imb, est = self._skew_figures()
        a = self.stages.get("map_out")
        b = self.stages.get("reduce_out")
        stages = {}
        for name in sorted(self.stages):
            st = self.stages[name]
            stages[name] = {
                "scope": st.scope,
                "rows": int(st.rows.sum(dtype=_U64)),
                "bytes": int(st.bytes.sum(dtype=_U64)),
                "rows_per_partition": st.rows.astype(np.int64).tolist(),
                "value_sum": int(st.vsum.sum(dtype=_U64)),
                "weighted_checksum": f"{int(st.wsum.sum(dtype=_U64)):#018x}",
                "pair_xor":
                    f"{int(np.bitwise_xor.reduce(st.xor)):#018x}",
                "pair_sum": f"{int(st.sum.sum(dtype=_U64)):#018x}",
            }
        distinct_out = (int(b.uniq.sum(dtype=_U64)) if b is not None
                        else 0)
        rows_in = int(a.rows.sum(dtype=_U64)) if a is not None else 0
        ratio_pp = []
        if a is not None and b is not None:
            for p_ in range(self.S):
                u = int(b.uniq[p_])
                ratio_pp.append(
                    round(int(a.rows[p_]) / u, 3) if u else 0.0)
        hot = []
        for k in sorted(self._hot, key=self._hot.get, reverse=True)[
                :self.top_k]:
            word = self._hot_resolved.get(k)
            if isinstance(word, bytes):
                word = word.decode("utf-8", "replace")
            hot.append({"hash": f"{int(k):#018x}", "key": word,
                        "rows": int(self._hot[k])})
        total_rows = float(rows.sum())
        m = 1 << self.p
        doc = {
            "schema": DATA_SCHEMA,
            "partitions": self.S,
            "virtual_partitions": self.virtual,
            "conserves": self.conserves,
            "records_in": self.records_in,
            "stages": stages,
            "conservation": {"checks": self.checks,
                             "violations": list(self.violations)},
            "skew": {
                "rows_per_partition": rows.astype(np.int64).tolist(),
                "distinct_est_per_partition":
                    [round(float(e), 1) for e in est],
                "distinct_est":
                    round(hll_union_estimate(self._regs, self.S, m), 1),
                "imbalance_factor": round(imb, 4),
                "hot_keys": hot,
                "top_share": (round(hot[0]["rows"] / total_rows, 4)
                              if hot and total_rows else 0.0),
            },
            "reduction": {
                "rows_in": rows_in,
                "distinct_out": distinct_out,
                "ratio": (round(rows_in / distinct_out, 3)
                          if distinct_out else 0.0),
                "ratio_per_partition": ratio_pp,
            },
        }
        return doc

    def publish(self, registry) -> None:
        """The flat ``data/*`` gauges of the job's summary."""
        rows, imb, est = self._skew_figures()
        a = self.stages.get("map_out")
        b = self.stages.get("reduce_out")
        rows_in = int(a.rows.sum(dtype=_U64)) if a is not None else 0
        distinct = int(b.uniq.sum(dtype=_U64)) if b is not None else 0
        registry.set("data/partitions", self.S)
        registry.set("data/rows_in", rows_in)
        registry.set("data/distinct_out", distinct)
        registry.set("data/distinct_est",
                     round(hll_union_estimate(self._regs, self.S,
                                              1 << self.p), 1))
        registry.set("data/imbalance_factor", round(imb, 4))
        if distinct:
            registry.set("data/reduction_ratio",
                         round(rows_in / distinct, 3))
        registry.set("data/conservation_checks", self.checks)
        registry.set("data/conservation_violations",
                     len(self.violations))
        if self._hot and rows.sum() > 0:
            top = max(self._hot.values())
            registry.set("data/hot_key_share",
                         round(top / float(rows.sum()), 4))


def hll_union_estimate(regs_flat: np.ndarray, S: int, m: int) -> float:
    """Global distinct estimate: the element-wise max of the S
    per-partition register rows is the HLL union sketch."""
    return hll_estimate(
        np.asarray(regs_flat).reshape(S, m).max(axis=0))


def ledger_section(doc: dict) -> dict:
    """The compact ``data`` section a ledger entry carries (full
    per-stage digests stay in the metrics document)."""
    skew = doc.get("skew") or {}
    red = doc.get("reduction") or {}
    return {
        "partitions": doc.get("partitions"),
        "rows_per_partition": skew.get("rows_per_partition"),
        "imbalance_factor": skew.get("imbalance_factor"),
        "reduction_ratio": red.get("ratio"),
        "distinct_out": red.get("distinct_out"),
        "violations": (doc.get("conservation") or {}).get("violations"),
    }


_BLOCKS = " ▁▂▃▄▅▆▇█"


def _bar(frac: float, width: int = 12) -> str:
    """A unicode block bar: ``frac`` of ``width`` cells filled."""
    cells = frac * width
    full = int(cells)
    rem = cells - full
    bar = "█" * full
    if rem > 0 and full < width:
        bar += _BLOCKS[max(1, int(rem * 8))]
    return bar.ljust(width)


def render(doc: dict) -> str:
    """Human rendering of the audit section: the conservation table,
    the per-partition skew heatmap, and the reduction-ratio gauges
    (the ``obs data`` CLI body)."""
    out = []
    S = doc.get("partitions", 0)
    virt = " (virtual)" if doc.get("virtual_partitions") else ""
    out.append(f"data plane: {S} hash partitions{virt}")
    cons = doc.get("conservation") or {}
    nviol = len(cons.get("violations") or [])
    verdict = "FAIL" if nviol else "OK"
    out.append(f"conservation: {cons.get('checks', 0)} checks, "
               f"{nviol} violations  [{verdict}]")
    for v in cons.get("violations") or []:
        out.append(f"  ! {v}")
    stages = doc.get("stages") or {}
    if stages:
        out.append(f"  {'stage':<12} {'rows':>12} {'bytes':>14} "
                   f"{'value sum':>14}  checksum")
        order = sorted(stages, key=lambda n: (n != "map_out", n))
        for name in order:
            st = stages[name]
            ck = (st["weighted_checksum"]
                  if int(st.get("value_sum") or 0) else st["pair_xor"])
            out.append(f"  {name:<12} {st['rows']:>12,} "
                       f"{st['bytes']:>14,} {st['value_sum']:>14,}  {ck}")
    skew = doc.get("skew") or {}
    rows = skew.get("rows_per_partition") or []
    red = doc.get("reduction") or {}
    ratio_pp = red.get("ratio_per_partition") or []
    est = skew.get("distinct_est_per_partition") or []
    if rows:
        peak = max(max(rows), 1)
        total = max(sum(rows), 1)
        out.append("")
        out.append(f"  {'part':>4} {'rows_in':>12} {'distinct~':>10} "
                   f"{'ratio':>8}  {'heat':<12} share")
        for p_ in range(len(rows)):
            e = est[p_] if p_ < len(est) else 0.0
            r = ratio_pp[p_] if p_ < len(ratio_pp) else 0.0
            out.append(
                f"  {p_:>4} {rows[p_]:>12,} {e:>10,.0f} "
                f"{r:>7.2f}x  {_bar(rows[p_] / peak)} "
                f"{100.0 * rows[p_] / total:>5.1f}%")
        out.append(f"imbalance factor {skew.get('imbalance_factor')} "
                   f"(max/mean partition rows)")
    if red.get("distinct_out"):
        out.append(f"reduction ratio {red.get('ratio')}x "
                   f"({red.get('rows_in'):,} rows in -> "
                   f"{red.get('distinct_out'):,} distinct keys out — "
                   f"the map-side combining budget)")
    hot = skew.get("hot_keys") or []
    if hot:
        out.append("hot keys: " + ", ".join(
            (f"{h['key']!r}" if h.get("key") else h["hash"])
            + f" ({h['rows']:,})" for h in hot[:5]))
    return "\n".join(out)
