"""Total-order sort (a copy of the JAX package's ``workloads/sort.py``:
``RESERVED_KEY``, ``OUT_REC``, ``load_records`` :52,
``iter_record_chunks`` :73, ``compute_splitters`` :104,
``range_partition`` :132, ``sample_keys`` :142, ``sort_model`` :159,
``write_sorted_records`` :168, ``read_sorted_records`` :187 there).

Every input row survives and the *order* is the product: on one device
the rows go through the pair collect with the full unsigned (key,
payload) order (:class:`~map_oxidize_tpu_torch.runtime.collect.
CollectEngine` with ``pair_order='lex'``), sorted on the host or on the
card, and are written in that order.  The range splitters serve the
sharded sort (:class:`~map_oxidize_tpu_torch.parallel.collect.
ShardedCollectEngine`, ``num_shards > 1``); on one device they are not
computed.

Record model: fixed-width binary (u64 key, u64 payload) rows — a
``.npy`` array of shape ``(n, 2)`` (column 0 the key) or ``(n,)``
(keys only; the payload defaults to the global row index, making every
record distinct and the sort stable-by-construction).  The record is
the shuffle layer's 16-byte on-disk format
(:class:`~map_oxidize_tpu_torch.shuffle.disk.DiskPairStage`), so a
beyond-RAM sort stages in the same top-bits disk buckets the pair
collect spills to; buckets are top-bit key ranges, so the
bucket-by-bucket drain (a full (key, payload) lexsort per bucket) is
the total order, with no extra merge pass.

This module holds the host-side pieces the driver
(:mod:`map_oxidize_tpu_torch.runtime.dataflow`) and the tests share:
record IO, the sampled range partitioner, and the NumPy oracle.
"""

from __future__ import annotations

import os

import numpy as np

#: the one key value the engines cannot carry: both u32 planes equal to
#: the padding SENTINEL (0xFFFFFFFF_FFFFFFFF) — a real row with this key
#: would be masked out as padding after the exchange.  The drivers
#: refuse it loudly per chunk instead of silently dropping the row.
RESERVED_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)

#: on-disk sorted-output record: little-endian (u64 key, u64 payload) —
#: byte-compatible with the shuffle layer's spill record, so part files
#: concatenate into one valid record stream
OUT_REC = np.dtype([("k", "<u8"), ("p", "<u8")])


def load_records(path: str):
    """Memory-map a records ``.npy``: returns ``(keys, payloads, n)``
    with ``keys`` a ``(n,)`` u64 view and ``payloads`` a ``(n,)`` u64
    view or ``None`` (keys-only input — consumers synthesize the global
    row index).  Accepts u64 or i64 storage (i64 is VIEWED as u64: the
    record model is 64 raw bits, not a signed quantity)."""
    arr = np.load(path, mmap_mode="r")
    if arr.dtype not in (np.dtype(np.uint64), np.dtype(np.int64)):
        raise ValueError(
            f"dataflow records must be uint64 (or int64, viewed as raw "
            f"bits); got dtype {arr.dtype} in {path!r}")
    if arr.ndim == 1:
        return arr.view(np.uint64), None, int(arr.shape[0])
    if arr.ndim == 2 and arr.shape[1] == 2:
        a = arr.view(np.uint64)
        return a[:, 0], a[:, 1], int(arr.shape[0])
    raise ValueError(
        f"dataflow records must be (n,) keys or (n, 2) (key, payload) "
        f"rows; got shape {arr.shape} in {path!r}")


def iter_record_chunks(path: str, rows_per_chunk: int, proc: int = 0,
                       n_proc: int = 1):
    """Yield this process's record chunks (chunk ``i % n_proc == proc``)
    as ``(keys, payloads, end_row)`` — materialized u64 arrays (the mmap
    slice copies), payloads synthesized as the GLOBAL row index for
    keys-only inputs.  Every process iterates the same deterministic
    chunk plan, so no coordination divides the input (the same contract
    as the JAX package's ``parallel.distributed._local_chunks``)."""
    keys, payloads, n = load_records(path)
    rows = max(1, rows_per_chunk)
    for ci, start in enumerate(range(0, n, rows)):
        stop = min(start + rows, n)
        if ci % n_proc != proc:
            continue
        k = np.ascontiguousarray(keys[start:stop])
        if bool((k == RESERVED_KEY).any()):
            raise ValueError(
                f"input contains the reserved key "
                f"{int(RESERVED_KEY):#018x} (the engine padding "
                "sentinel); dataflow records must avoid exactly this "
                "one value")
        if payloads is None:
            p = np.arange(start, stop, dtype=np.uint64)
        else:
            p = np.ascontiguousarray(payloads[start:stop])
        yield k, p, stop


# --- the sampled range partitioner -----------------------------------------


def compute_splitters(sample: np.ndarray, num_shards: int) -> np.ndarray:
    """``num_shards - 1`` ascending u64 splitter keys from a key sample:
    the sorted sample's ``i/S`` quantiles.  Shard ``s`` then owns keys
    in ``[splitters[s-1], splitters[s])`` with ties broken
    deterministically toward the RIGHT shard (a key equal to splitter
    ``j`` lands on shard ``j+1`` — see :func:`range_partition`).

    Properties the suite pins on adversarial inputs (skew, duplicate
    floods, empty samples): the splitters are nondecreasing, the induced
    partition covers every u64 exactly once, and the shard index is
    monotone in the key.  A duplicate-heavy sample may yield EQUAL
    splitters — empty shards, which are valid (and what extreme skew
    honestly deserves); an EMPTY sample falls back to evenly spaced
    u64-space splitters so the partition still covers."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    S = num_shards
    if S == 1:
        return np.empty(0, np.uint64)
    sample = np.asarray(sample, np.uint64).ravel()
    if sample.size == 0:
        return np.array([(i * (1 << 64)) // S for i in range(1, S)],
                        dtype=np.uint64)
    srt = np.sort(sample)
    idx = (np.arange(1, S, dtype=np.int64) * srt.size) // S
    return srt[idx].copy()


def range_partition(keys: np.ndarray, splitters: np.ndarray) -> np.ndarray:
    """Owner shard per key under the range partition — the HOST spelling
    of the JAX package's ``parallel.shuffle.range_dest`` (the in-trace
    one), which its property suite holds bit-identical to this: the
    count of splitters ``<=`` key, i.e. ``searchsorted(splitters, key, side='right')``."""
    return np.searchsorted(np.asarray(splitters, np.uint64),
                           np.asarray(keys, np.uint64),
                           side="right").astype(np.int64)


def sample_keys(path: str, target: int) -> np.ndarray:
    """Deterministic strided key sample of the WHOLE file: identical on
    every process by construction (the input is visible to every host —
    the same shared-storage contract distributed k-means already has),
    so distributed splitters need no collective.  Strided rather than
    random: quantiles of an every-kth-row sample converge the same way
    and reproduce bit-for-bit."""
    keys, _payloads, n = load_records(path)
    if n == 0:
        return np.empty(0, np.uint64)
    stride = max(1, n // max(1, target))
    return np.ascontiguousarray(keys[::stride])


# --- oracle + output -------------------------------------------------------


def sort_model(keys: np.ndarray, payloads: np.ndarray):
    """Pure-NumPy oracle: rows sorted by (key, payload), both compared
    as u64.  Independent of every engine under test."""
    keys = np.asarray(keys, np.uint64)
    payloads = np.asarray(payloads, np.uint64)
    order = np.lexsort((payloads, keys))
    return keys[order], payloads[order]


def write_sorted_records(path: str, runs) -> int:
    """Stream sorted ``(keys, docs)`` runs to ``path`` as
    :data:`OUT_REC` records (atomic: temp + rename).  One run is
    resident at a time — the spilled drain hands one disk bucket per
    run, so a beyond-RAM sort writes with bounded memory.  Returns the
    row count written."""
    n = 0
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        for keys, docs in runs:
            rec = np.empty(keys.shape[0], OUT_REC)
            rec["k"] = np.asarray(keys, np.uint64)
            rec["p"] = np.asarray(docs).view(np.uint64)
            f.write(rec.tobytes())
            n += int(keys.shape[0])
    os.replace(tmp, path)
    return n


def read_sorted_records(path: str):
    """Read an :data:`OUT_REC` artifact back as ``(keys, payloads)``
    u64 arrays (tests and the smoke assertions)."""
    rec = np.fromfile(path, OUT_REC)
    return rec["k"].copy(), rec["p"].copy()
