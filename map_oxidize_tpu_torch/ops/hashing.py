"""64-bit key hashing for string keys (a copy of the JAX package's
``ops.hashing``, bit for bit, so the port imports nothing from it).

Every key is committed to a 64-bit hash carried as a pair of ``uint32``
planes ``(hi, lo)`` on the host; the port's device code joins them into one
int64 order key (:mod:`map_oxidize_tpu_torch.ops.segment_reduce`).  Host-side
dictionaries (hash -> original token bytes) are unioned at readback so exact
strings are recoverable, and any collision (same hash, different bytes)
raises.
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF

#: Key value reserved for padding rows on device.  Rows whose (hi, lo) both
#: equal SENTINEL sort to the end and are excluded from unique-key counts.
SENTINEL = 0xFFFFFFFF
SENTINEL64 = 0xFFFFFFFFFFFFFFFF


_M1 = 0x9E3779B97F4A7C15
_M2 = 0xC2B2AE3D27D4EB4F
_M3 = 0x165667B19E3779F9


def moxt64_bytes(data: bytes) -> int:
    """The canonical key hash, mirrored bit-for-bit by the C++ hot loop
    (``native/csrc/moxt_native.cpp`` ``moxt64``).

    Spec: ``h = len * K3``; one round per 16-byte block (zero-padded past the
    end, at least one round even for empty input):

        ``h = fold128((w0 ^ K1 ^ h) * (w1 ^ K2 ^ rotl(h, 32)))``

    with ``w0``/``w1`` the little-endian u64 halves and ``fold128(m) =
    lo64(m) ^ hi64(m)`` of the full 128-bit product (wyhash-style folded
    multiply — a plain 64-bit multiply only propagates differences upward and
    measurably collides on structured keys); then the splitmix64 finalizer.
    A result equal to ``SENTINEL64`` (the device padding key) is remapped to
    ``SENTINEL64 - 1`` so no real key can masquerade as padding.

    Chosen over FNV-1a because FNV's byte-serial multiply chain caps a host
    core near ~150 MB/s; this runs one (widening) multiply per 16 bytes.
    """
    n = len(data)
    h = (n * _M3) & _MASK64
    i = 0
    while True:
        w0 = int.from_bytes(data[i:i + 8].ljust(8, b"\0"), "little")
        w1 = int.from_bytes(data[i + 8:i + 16].ljust(8, b"\0"), "little")
        rot = ((h << 32) | (h >> 32)) & _MASK64
        m = (w0 ^ _M1 ^ h) * (w1 ^ _M2 ^ rot)
        h = (m & _MASK64) ^ (m >> 64)
        i += 16
        if i >= n:
            break
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _MASK64
    h ^= h >> 31
    if h == SENTINEL64:
        h = SENTINEL64 - 1
    return h


def fnv1a64_bytes(data: bytes) -> int:
    """FNV-1a 64-bit of ``data`` (legacy; mapper paths use
    :func:`moxt64_bytes`).  Shares the SENTINEL64 remap so a pathological
    token can never alias the device padding key."""
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & _MASK64
    if h == SENTINEL64:
        h = SENTINEL64 - 1
    return h


def fnv1a64(token: "bytes | str") -> int:
    if isinstance(token, str):
        token = token.encode("utf-8")
    return fnv1a64_bytes(token)


def moxt64(token: "bytes | str") -> int:
    if isinstance(token, str):
        token = token.encode("utf-8")
    return moxt64_bytes(token)


def hash_tokens(tokens) -> np.ndarray:
    """Hash an iterable of tokens (bytes or str) to a uint64 array with the
    canonical mapper hash."""
    return np.fromiter(
        (moxt64(t) for t in tokens), dtype=np.uint64, count=len(tokens)
    )


def split_u64(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 -> (hi, lo) uint32 planes, the on-device key representation."""
    h = np.asarray(h, dtype=np.uint64)
    hi = (h >> np.uint64(32)).astype(np.uint32)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 planes -> uint64, for host-side dictionary lookup."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


class HashDictionary:
    """Host-side hash -> token-bytes mapping with collision detection.

    Replaces the reference's reliance on real strings flowing through every
    phase (main.rs:105-107 writes ``"{word} {count}"`` text; main.rs:158-165
    re-parses it).  Here strings stay on the host; only hashes travel.

    Column-delta fast path: the native drain hands back (hashes, lens, blob)
    arrays; ``add_arrays`` stores them O(1) and materialization (the per-key
    Python loop, with collision checking) is deferred to the first lookup —
    so a wide-key-space job (bigram: ~|V|^2 keys) pays the loop ONCE at
    finalize instead of per chunk per accumulation site.  ``upper_bound()``
    serves the engine's capacity hints without forcing the flush.
    """

    __slots__ = ("_d", "_pending", "_pending_rows")

    def __init__(self) -> None:
        self._d: dict[int, bytes] = {}
        self._pending: list = []     # (u64 hashes, i64 lens, bytes blob)
        self._pending_rows = 0

    def __len__(self) -> int:
        self._flush()
        return len(self._d)

    def upper_bound(self) -> int:
        """Distinct keys <= this.  Pending rows may duplicate existing keys
        (multi-worker streams re-drain the shared vocabulary; resume replays
        plus a fresh stream re-drains), so an unchecked sum would inflate
        the engine's capacity hint until it stopped ruling growth out and
        the feed path paid device syncs again.  When duplicates could
        dominate, flush to re-tighten — total flush work is bounded by total
        drained rows, the same budget the eager per-chunk loop spent."""
        if self._pending_rows > max(4096, len(self._d)):
            self._flush()
        return len(self._d) + self._pending_rows

    def _add_checked(self, h: int, token: bytes) -> None:
        """The one collision check-and-insert (every mutation path funnels
        here so a policy change lands exactly once)."""
        prev = self._d.get(h)
        if prev is None:
            self._d[h] = token
        elif prev != token:
            raise ValueError(
                f"64-bit hash collision: {prev!r} and {token!r} both hash to {h:#x}"
            )

    def add(self, h: int, token: bytes) -> None:
        self._flush()
        self._add_checked(h, token)

    def add_arrays(self, hashes, lens, blob: bytes) -> None:
        """Queue a columnar delta (hashes ``u64[n]``, lens ``i64[n]``, token
        bytes concatenated in order).  O(1); collision checks run at flush."""
        n = int(len(hashes))
        if n:
            if not isinstance(blob, bytes):
                blob = bytes(blob)  # so flush-time slices are final copies
            self._pending.append((hashes, lens, blob))
            self._pending_rows += n

    def _flush(self) -> None:
        if not self._pending:
            return
        pend, self._pending, self._pending_rows = self._pending, [], 0
        add = self._add_checked
        for hashes, lens, blob in pend:
            offs = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            ol = offs.tolist()
            for i, h in enumerate(hashes.tolist()):
                add(h, blob[ol[i]:ol[i + 1]])

    def update(self, other: "HashDictionary | dict[int, bytes]") -> None:
        if isinstance(other, HashDictionary):
            # SHARE the other side's pending deltas (O(1) per delta; arrays
            # are never mutated, so aliasing is safe) — our own flush will
            # materialize + collision-check them.  ``other`` keeps its
            # deltas: callers may still serialize it afterwards (the
            # checkpoint spill does exactly that with the per-chunk output).
            self._pending.extend(other._pending)
            self._pending_rows += other._pending_rows
            items = other._d.items()
        else:
            items = other.items()
        if items:
            self._flush()
            for h, tok in items:
                self._add_checked(h, tok)

    def materialized(self) -> dict[int, bytes]:
        """The flushed hash -> bytes dict (read-only by convention)."""
        self._flush()
        return self._d

    def to_arrays(self):
        """All entries as ``(hashes u64, lens i64, blob u8)`` columns.  A
        dictionary that is purely one pending delta (the per-chunk native
        drain) passes its arrays through without materializing — the
        checkpoint spill path stays O(1) in Python."""
        if not self._d and len(self._pending) == 1:
            h, lens, blob = self._pending[0]
            return (np.ascontiguousarray(h, np.uint64),
                    np.asarray(lens, np.int64),
                    np.frombuffer(blob, np.uint8))
        self._flush()
        d = self._d
        hashes = np.fromiter(d.keys(), np.uint64, count=len(d))
        toks = list(d.values())
        lens = np.fromiter((len(t) for t in toks), np.int64, count=len(toks))
        blob = (np.frombuffer(b"".join(toks), np.uint8) if toks
                else np.empty(0, np.uint8))
        return hashes, lens, blob

    def lookup(self, h: int) -> bytes:
        self._flush()
        return self._d[h]

    def get(self, h: int, default: bytes | None = None) -> bytes | None:
        self._flush()
        return self._d.get(h, default)

    def items(self):
        self._flush()
        return self._d.items()
