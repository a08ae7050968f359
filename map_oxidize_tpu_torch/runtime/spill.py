"""Top-bits disk-bucket partition shared by the beyond-RAM paths (a copy of
the JAX package's ``runtime/spill.py``: ``DEFAULT_BITS``,
``partition_top_bits``, ``BucketFiles``).

Both external-memory engines (the host collect-reduce's count / (key,
value) spill and the pair collect's (key, doc) spill) stable-partition
each fed block by the top ``bits`` of the u64 key into per-bucket append
files, then drain one bucket at a time at finalize.  Random hash keys
split ~uniformly, and buckets are top-bit RANGES, so bucket-by-bucket
output concatenates into the globally key-ascending order every
downstream consumer expects.  The stable partition preserves feed order
within a bucket — the invariant the pair engine's stable finalize sort
relies on for ascending doc ids.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

#: default bucket count: top 8 key bits.  Crossing a ~2GB cap leaves
#: ~8MB buckets, each reduced entirely in cache-resident memory.
DEFAULT_BITS = 8


def partition_top_bits(keys: np.ndarray, bits: int):
    """Stable partition order for u64 ``keys`` by their top ``bits``:
    returns ``(order, counts, offs)`` such that ``keys[order]`` groups
    bucket ``i``'s rows at ``[offs[i], offs[i+1])`` in feed order."""
    bucket = (keys >> np.uint64(64 - bits)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=1 << bits)
    offs = np.concatenate([[0], np.cumsum(counts)])
    return order, counts, offs


class BucketFiles:
    """Per-bucket append files under one temp directory, open on demand.
    One file set per record flavour (``suffix``) — a bucket may hold e.g.
    bare-key rows AND (key, value) records of the same key range."""

    def __init__(self, prefix: str, bits: int = DEFAULT_BITS):
        self.bits = bits
        self._dir = tempfile.TemporaryDirectory(prefix=prefix)
        self._files: dict[str, list] = {}

    @property
    def path(self) -> str:
        return self._dir.name

    def _path(self, suffix: str, i: int) -> str:
        return os.path.join(self._dir.name, f"bucket_{i:03d}.{suffix}")

    def write_partitioned(self, suffix: str, rows: np.ndarray,
                          counts: np.ndarray, offs: np.ndarray) -> None:
        """Append ``rows`` (already partition-ordered; any record dtype)
        to each non-empty bucket's ``suffix`` file."""
        files = self._files.setdefault(suffix, [None] * (1 << self.bits))
        for i in np.flatnonzero(counts):
            f = files[i]
            if f is None:
                f = open(self._path(suffix, i), "wb")
                files[i] = f
            f.write(rows[offs[i]:offs[i + 1]].tobytes())

    def take(self, suffix: str, i: int, dtype) -> "np.ndarray | None":
        """Drain bucket ``i``'s ``suffix`` file: flush/close, read as
        ``dtype`` records, unlink (peak disk = rows once), return the
        array — or None if the bucket never received that flavour."""
        files = self._files.get(suffix)
        f = files[i] if files else None
        if f is None:
            return None
        f.flush()
        f.close()
        files[i] = None
        path = self._path(suffix, i)
        arr = np.fromfile(path, dtype)
        os.unlink(path)
        return arr

    def cleanup(self) -> None:
        for files in self._files.values():
            for f in files:
                if f is not None:
                    f.close()
        self._files = {}
        self._dir.cleanup()

    def release(self):
        """Hand the underlying temp directory to the caller (it stays
        alive as long as the returned handle does) — used when finalize
        leaves an artifact (the pair engine's doc column) on disk."""
        for files in self._files.values():
            for f in files:
                if f is not None:
                    f.close()
        self._files = {}
        d, self._dir = self._dir, None
        return d
