"""Pipelined push transport (a copy of the JAX package's
``shuffle/pipelined.py``: ``PipelinedTransport``, ``COMBINABLE``,
``combine_map_output``, ``record_push_combine``).

The barrier between map and shuffle is not in the dataflow: each mapped
block's rows already know their owner, so they can be pushed and merged
while map still produces the next block.

* **placement** — identical to hybrid: resident until the cap, then the
  one-way demotion to disk buckets.  ``admit`` answers ``"push"`` instead
  of ``"resident"`` under the cap (the PUSHING state), which engines
  treat as resident placement and drivers as the push-cadence signal.
* **push cadence** — the driver's half: the map runs in the bounded
  prefetcher (``runtime/pipeline.py``, spans ``push/produce`` /
  ``push/feed_wait``) at depth >= 2, so block i+1's host map overlaps
  block i's feed.
* **map-side combiner** — :func:`combine_map_output` combines the partial
  fold states of one push window before the feed, so aggregation
  workloads feed combined partials instead of raw rows.  The data-plane
  audit's weighted checksum (``sum(mix64(key) * value) mod 2^64``,
  :mod:`map_oxidize_tpu_torch.obs.dataplane`) is sum-combine-invariant,
  so the audits hold with the combiner on.

Evidence: ``shuffle/push_combined_in`` / ``_out`` /
``shuffle/push_bytes_saved`` (the combiner's reduction) and the
``pipeline/shuffle_overlap_ratio`` gauge (the share of host map time the
push pipeline hid).
"""

from __future__ import annotations

import numpy as np

from map_oxidize_tpu_torch.shuffle.base import ShuffleTransport

#: reducer combine monoids the map-side combiner can pre-apply: the
#: combine must be associative AND idempotent under regrouping — exactly
#: the host collect-reduce engine's vocabulary (sum of partials, min of
#: partials, max of partials all equal the combine over raw rows)
COMBINABLE = {"sum": np.add, "min": np.minimum, "max": np.maximum}

#: nominal staged bytes per scalar fold row (u64 key + i32 value) — the
#: ``shuffle/push_bytes_saved`` accounting unit
FOLD_ROW_BYTES = 12


class PipelinedTransport(ShuffleTransport):
    """PUSHING until the cap trips, then SPILLED for good (hybrid's
    placement ladder with the eager-push verdict under the cap)."""

    name = "pipelined"

    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        if self.spilled_state:
            return "spill"
        if resident_rows > max_rows:
            self.spilled_state = True
            return "demote"
        return "push"


def combine_map_output(out, combine: str):
    """Sum-combine one push window's partial fold states: collapse
    duplicate keys in a scalar-fold :class:`~map_oxidize_tpu_torch.api.MapOutput`
    with the reducer's combine monoid (``COMBINABLE``), returning
    ``(combined_out, rows_in, rows_out)``.

    ``values=None`` (the hash-only implicit-ones form) combines to
    explicit int32 counts under ``sum``.  The output carries the input's
    dictionary and ``records_in`` unchanged — combining changes the row
    *count*, never the record accounting — and has its key planes
    materialized so plane-bound consumers (device engines, the
    distributed block concatenation) need no special case.  Identity
    blocks (already all-distinct) pass through untouched."""
    from map_oxidize_tpu_torch.api import MapOutput
    from map_oxidize_tpu_torch.ops.hashing import join_u64

    ufunc = COMBINABLE.get(combine)
    if ufunc is None:
        raise ValueError(
            f"map-side combiner supports {sorted(COMBINABLE)} combines, "
            f"got {combine!r}")
    k64 = (out.keys64 if out.keys64 is not None
           else join_u64(out.hi, out.lo))
    n = int(k64.shape[0])
    if n == 0:
        return out, 0, 0
    order = np.argsort(k64, kind="stable")
    ks = k64[order]
    bounds = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    uniq = ks[bounds]
    if uniq.shape[0] == n:
        return out, n, n
    if out.values is None:
        if combine != "sum":
            raise ValueError(
                "implicit all-ones values only combine under 'sum', "
                f"got {combine!r}")
        vals = np.diff(np.append(bounds, n)).astype(np.int32)
    else:
        v = np.asarray(out.values)
        if v.ndim != 1:
            # vector fold states (k-means partials) keep their engine-side
            # combine; the map-side window combiner is scalar-only
            return out, n, n
        vals = ufunc.reduceat(v[order], bounds).astype(v.dtype, copy=False)
    combined = MapOutput(hi=None, lo=None, values=vals,
                         dictionary=out.dictionary,
                         records_in=out.records_in, keys64=uniq)
    combined.ensure_planes()
    return combined, n, int(uniq.shape[0])


def record_push_combine(obs, rows_in: int, rows_out: int) -> None:
    """The one combiner-evidence record (``shuffle/push_combined_in`` /
    ``_out`` / ``shuffle/push_bytes_saved``), shared by the
    single-controller and distributed push paths so the bench A-B and
    the ledger gate compare identical counters."""
    if obs is None or rows_in == 0:
        return
    reg = obs.registry
    reg.count("shuffle/push_combined_in", rows_in)
    reg.count("shuffle/push_combined_out", rows_out)
    if rows_in > rows_out:
        reg.count("shuffle/push_bytes_saved",
                  (rows_in - rows_out) * FOLD_ROW_BYTES)
