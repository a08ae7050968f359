"""Sessionize, a gap-cut windowed group-by (a copy of the JAX package's
``workloads/sessionize.py``: ``sessions_from_csr`` :23,
``sessionize_model`` :51, ``sort_sessions`` :79, ``write_sessions``
:86).

Input: event records in the :mod:`workloads.sort` model — (u64 entity
key, u64 timestamp) rows, any order.  The workload groups each entity's
events, orders them by time, and cuts SESSIONS wherever the gap between
consecutive events exceeds ``session_gap``; the output is one
``(key, start_ts, end_ts, n_events)`` row per session.

Engine-wise this is the pair collect verbatim: the (key, ts) sort
leaves each key's segment time-ascending, then ONE vectorized pass over
the grouped CSR finds every session boundary (:func:`sessions_from_csr`):
a session starts at each segment head and at each in-segment gap >
``session_gap``.
"""

from __future__ import annotations

import numpy as np


def sessions_from_csr(terms: np.ndarray, offsets: np.ndarray,
                      docs: np.ndarray, gap: int):
    """Gap-cut the grouped CSR (``docs`` = timestamps, time-ascending
    within each ``offsets`` segment) into sessions.  Returns
    ``(keys, start, end, count)`` — one row per session, following
    ``terms`` order across keys and time order within a key."""
    terms = np.asarray(terms, np.uint64)
    offsets = np.asarray(offsets, np.int64)
    n = int(offsets[-1]) if offsets.size else 0
    if n == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                np.empty(0, np.uint64), np.empty(0, np.int64))
    ts = np.asarray(docs[:n]).view(np.uint64)
    seg_start = np.zeros(n, bool)
    seg_start[offsets[:-1]] = True
    prev = np.empty(n, np.uint64)
    prev[1:] = ts[:-1]
    prev[0] = 0
    # within a segment ts is ascending, so the u64 difference is exact;
    # the first row of each segment is a start regardless of the diff
    cut = seg_start | (ts - prev > np.uint64(gap))
    bounds = np.flatnonzero(cut)
    counts = np.diff(np.append(bounds, n)).astype(np.int64)
    row_keys = np.repeat(terms, np.diff(offsets))
    return (row_keys[bounds], ts[bounds].copy(),
            ts[bounds + counts - 1].copy(), counts)


def sessionize_model(keys, ts, gap: int):
    """Pure-host oracle: ``(keys, start, end, count)`` sorted by
    (key, start) — plain dict grouping + per-key sort, independent of
    every engine."""
    by_key: dict[int, list[int]] = {}
    for k, t in zip(np.asarray(keys, np.uint64).tolist(),
                    np.asarray(ts, np.uint64).tolist()):
        by_key.setdefault(k, []).append(t)
    rows = []
    for k in sorted(by_key):
        times = sorted(by_key[k])
        start = prev = times[0]
        count = 1
        for t in times[1:]:
            if t - prev > gap:
                rows.append((k, start, prev, count))
                start, count = t, 0
            count += 1
            prev = t
        rows.append((k, start, prev, count))
    if not rows:
        e = np.empty(0, np.uint64)
        return e, e.copy(), e.copy(), np.empty(0, np.int64)
    arr = np.array(rows, dtype=np.uint64)
    return (arr[:, 0], arr[:, 1], arr[:, 2],
            arr[:, 3].astype(np.int64))


def sort_sessions(keys, start, end, count):
    """Deterministic artifact order: (key, start) ascending — the
    oracle's order, regardless of which shard produced which segment."""
    order = np.lexsort((start, keys))
    return keys[order], start[order], end[order], count[order]


def write_sessions(path: str, keys, start, end, count) -> int:
    """One text line per session — ``key<TAB>start<TAB>end<TAB>count``
    (human-greppable; session rows are tiny next to their events).
    Atomic temp + rename."""
    import os

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for k, s, e, c in zip(keys.tolist(), start.tolist(),
                              end.tolist(), count.tolist()):
            f.write(f"{k}\t{s}\t{e}\t{c}\n")
    os.replace(tmp, path)
    return int(keys.shape[0])
