"""Hash equi-join (a copy of the JAX package's ``workloads/join.py``:
``SIDE_BIT``, ``JOIN_REC``, ``check_join_payloads`` :39, ``tag_side``
:47, ``probe_join_csr`` :54, ``csr_from_sorted`` :97, ``join_model``
:112, ``lexsort_matches`` :133, ``write_join_records`` :140,
``read_join_records`` :155).

Two record corpora R and S (the :mod:`workloads.sort` record model:
(u64 key, u64 payload) rows) join on key: the output is one
``(key, r_payload, s_payload)`` row per matching pair.  Both corpora
feed one pair-collect engine:

* each row's doc plane carries the payload with the SIDE tagged in the
  top bit (:data:`SIDE_BIT`): after the engine's (key, doc-as-u64)
  sort, every key segment is R-rows-then-S-rows — the build side and
  the probe side, already separated;
* the probe is one vectorized CSR cross-product expansion per key
  segment (:func:`probe_join_csr`) — no per-row Python.

The side bit costs one payload bit: join payloads must be < 2^63
(:func:`check_join_payloads` refuses loudly).  The sort workload keeps
the full 64.
"""

from __future__ import annotations

import numpy as np

#: side tag riding the payload's top bit: 0 = left/build (R), 1 =
#: right/probe (S).  Unsigned doc compare sorts every R row of a key
#: segment ahead of every S row.
SIDE_BIT = np.uint64(1) << np.uint64(63)
PAYLOAD_MASK = SIDE_BIT - np.uint64(1)

#: on-disk joined record: (key, r_payload, s_payload), little-endian
JOIN_REC = np.dtype([("k", "<u8"), ("a", "<u8"), ("b", "<u8")])


def check_join_payloads(payloads: np.ndarray, corpus: str) -> None:
    """Join payloads must leave the side bit free."""
    if bool((np.asarray(payloads, np.uint64) & SIDE_BIT).any()):
        raise ValueError(
            f"join payloads must be < 2**63 (the top bit tags the "
            f"side); corpus {corpus!r} violates that")


def tag_side(payloads: np.ndarray, right: bool) -> np.ndarray:
    """Payload column with the side bit applied (right/probe side
    only)."""
    p = np.asarray(payloads, np.uint64)
    return (p | SIDE_BIT) if right else p


def probe_join_csr(terms: np.ndarray, offsets: np.ndarray,
                   docs: np.ndarray):
    """Vectorized build/probe over a grouped CSR: ``terms`` the distinct
    keys, ``docs`` the side-tagged payload column sorted ascending (as
    u64) within each ``offsets`` segment — so each segment is its R rows
    then its S rows.  Returns ``(keys, r_pay, s_pay)`` u64 arrays: the
    cross product per matched key, ordered (r, s)-ascending within a
    key and following ``terms`` order across keys.

    The expansion is the classic CSR cross-product index arithmetic
    (segment id per output row -> ``pos // b`` into the R block,
    ``pos % b`` into the S block) — O(matches) array work, zero per-row
    Python."""
    terms = np.asarray(terms, np.uint64)
    offsets = np.asarray(offsets, np.int64)
    if terms.size == 0:
        e = np.empty(0, np.uint64)
        return e, e.copy(), e.copy()
    docs_u = np.asarray(docs).view(np.uint64)
    seg_len = np.diff(offsets)
    is_s = (docs_u & SIDE_BIT) != 0
    # S-side rows per segment; R rows are the prefix (unsigned doc sort)
    b = np.add.reduceat(is_s.astype(np.int64), offsets[:-1])
    a = seg_len - b
    m = a * b
    matched = m > 0
    if not matched.any():
        e = np.empty(0, np.uint64)
        return e, e.copy(), e.copy()
    a_m, b_m, m_m = a[matched], b[matched], m[matched]
    a_start = offsets[:-1][matched]
    b_start = a_start + a_m
    total = int(m_m.sum())
    seg = np.repeat(np.arange(m_m.size, dtype=np.int64), m_m)
    pos = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(m_m) - m_m, m_m)
    ai = a_start[seg] + pos // b_m[seg]
    bi = b_start[seg] + pos % b_m[seg]
    keys = terms[matched][seg]
    return (keys, docs_u[ai].copy(),
            (docs_u[bi] & PAYLOAD_MASK))


def csr_from_sorted(keys: np.ndarray, docs: np.ndarray):
    """Boundary-detect a (key-grouped, doc-sorted) row stream into the
    ``(terms, offsets, docs)`` CSR the probe and sessionize consumers
    take — the resident twin of the spilled engines'
    ``finalize_spilled_csr``."""
    keys = np.asarray(keys, np.uint64)
    if keys.shape[0] == 0:
        return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.asarray(docs))
    bounds = np.flatnonzero(
        np.concatenate([[True], keys[1:] != keys[:-1]]))
    return (keys[bounds],
            np.append(bounds, keys.shape[0]).astype(np.int64), docs)


def join_model(keys_a, pay_a, keys_b, pay_b):
    """Pure-host oracle: every (key, a, b) match, lexsorted by
    (key, a, b).  Independent of the engines (plain dict build +
    probe)."""
    build: dict[int, list[int]] = {}
    for k, p in zip(np.asarray(keys_a, np.uint64).tolist(),
                    np.asarray(pay_a, np.uint64).tolist()):
        build.setdefault(k, []).append(p)
    out = []
    for k, p in zip(np.asarray(keys_b, np.uint64).tolist(),
                    np.asarray(pay_b, np.uint64).tolist()):
        for ap in build.get(k, ()):
            out.append((k, ap, p))
    out.sort()
    if not out:
        e = np.empty(0, np.uint64)
        return e, e.copy(), e.copy()
    arr = np.array(out, dtype=np.uint64)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def lexsort_matches(keys, a, b):
    """Deterministic artifact order: (key, r_payload, s_payload)
    ascending."""
    order = np.lexsort((b, a, keys))
    return keys[order], a[order], b[order]


def write_join_records(path: str, keys, a, b) -> int:
    """Write joined rows as :data:`JOIN_REC` records (atomic)."""
    import os

    rec = np.empty(keys.shape[0], JOIN_REC)
    rec["k"] = keys
    rec["a"] = a
    rec["b"] = b
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(rec.tobytes())
    os.replace(tmp, path)
    return int(keys.shape[0])


def read_join_records(path: str):
    rec = np.fromfile(path, JOIN_REC)
    return rec["k"].copy(), rec["a"].copy(), rec["b"].copy()
