"""On-device tokenization: the device mapper's map phase, in torch ops and
one hand-written Hopper kernel.

The port of the JAX package's ``ops/device_tokenize.py`` (``P1``/``P2``,
``_mod_inverse_pow2`` :56, ``_power_tables`` :65, ``tokenize_hash`` :85,
``_compact_tokens`` :124, ``_dedup_chunk`` :139, ``_ngram_rows`` :184,
``tokenize_count_core`` :215, ``pad_chunk`` :253, ``DeviceTokenizer`` :264,
``token_at`` :302, ``ngram_at`` :314).  Raw chunk bytes go to the device,
which tokenizes and combines them:

1. lowercase + whitespace-classify every byte;
2. token start/end flags from mask edges;
3. **prefix-sum polynomial hashing**: with ``S[i] = sum_j (b[j]+1) *
   Pinv^j`` (uint32 wraparound), the hash of the token spanning [s, e] is
   ``P^e * (S[e] - S[s-1]) = sum (b[j]+1) * P^(e-j)``; two independent
   odd multipliers give two 32-bit hashes, the engine's (hi, lo) key;
4. compaction into dense token rows, optional n-gram rows, then a sort and
   segment-reduce down to the chunk's unique keys, each with a count and
   a representative start offset — the host sees only those.

Steps 1-3 and the compaction are one CUDA kernel on the card
(:func:`tokenize_compact`, ``csrc/tokenize_compact.cu``), bit-equal to
:func:`tokenize_compact_plain` (the torch form of ``tokenize_hash`` +
``_compact_tokens``, which CPU tensors take).  The n-gram rows, the
dedup and the packing stay torch ops.

**u32 arithmetic in torch.**  Every u32 value is held in int64 and masked
to 32 bits after each step: ``torch.cumsum`` widens instead of wrapping,
and a 32 x 32-bit product is split into two 48-bit halves
(:func:`_mulu32`), so nothing relies on int64 overflow.  Token-row planes
leave these functions as int32 tensors holding the u32 bit patterns (as
the port's collect blocks do); the host reads them with ``.view(uint32)``.

The device hash is NOT the host mappers' moxt64: keys are internal, parity
is defined on (word, count) multisets, so host and device mappers never
mix within one job.
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import torch

from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.ops.segment_reduce import (
    SENTINEL_KEY,
    keys_from_plane_tensors,
    plane_tensors_from_keys,
)

#: polynomial multipliers: odd (invertible mod 2^32), independent; P1 is the
#: 32-bit FNV prime, P2 a murmur3 finalizer constant
P1 = 0x01000193
P2 = 0x85EBCA6B

_WS = (32, 9, 10, 13, 11, 12)  # ' ' \t \n \r \v \f — bytes.split() semantics
_M32 = 0xFFFFFFFF
_INT32_MAX = (1 << 31) - 1

#: odd mixing multipliers for composing adjacent token hashes into an n-gram
#: key (uint32 wraparound; golden-ratio and murmur-style constants)
_NG1 = 0x9E3779B1
_NG2 = 0xC2B2AE35

_LIB = "tokenize_compact"


def _mod_inverse_pow2(a: int, bits: int = 32) -> int:
    """Inverse of odd ``a`` modulo 2**bits (Newton iteration)."""
    x = a  # correct to 3 bits
    for _ in range(6):
        x = (x * (2 - a * x)) % (1 << bits)
    return x


@functools.lru_cache(maxsize=None)
def _power_tables(n: int) -> tuple[np.ndarray, ...]:
    """(P1^i, P1^-i, P2^i, P2^-i) mod 2^32 for i in [0, n) — host-computed
    constants (numpy unsigned arithmetic wraps mod 2^32), cached per size."""
    out = []
    for p in (P1, P2):
        pinv = _mod_inverse_pow2(p)
        for mult in (p, pinv):
            a = np.full(n, mult, np.uint32)
            a[0] = 1
            out.append(np.multiply.accumulate(a, dtype=np.uint32))
    return tuple(out)


@functools.lru_cache(maxsize=2)
def _device_tables(n: int, device: str) -> tuple[torch.Tensor, ...]:
    """:func:`_power_tables` as int64 tensors on ``device`` (the plain
    version's operands; the kernel needs none)."""
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device)
                 for t in _power_tables(n))


def _mulu32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 tensors (or an int ``b``) holding u32
    values, without int64 overflow: ``b`` splits into 16-bit halves, each
    product staying below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = (a * ((b >> 16) & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return x.to(torch.int64) & _M32


def _is_space(b: torch.Tensor) -> torch.Tensor:
    m = b == _WS[0]
    for w in _WS[1:]:
        m = m | (b == w)
    return m


def tokenize_hash(chunk: torch.Tensor, pk1, pki1, pk2, pki2):
    """Per-position ``(h1, h2, tok_start, start, end)`` over a padded byte
    chunk (JAX ``tokenize_hash``).

    ``chunk``: ``[N]`` uint8, padded to N with ASCII spaces; the tables are
    :func:`_device_tables`.  ``h1``/``h2`` are int64 u32 values and
    ``tok_start`` int64; token rows live at end-flag positions."""
    n = chunk.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=chunk.device)
    c = chunk.to(torch.int64)
    b = torch.where((c >= 65) & (c <= 90), c + 32, c)  # ascii lower
    nsp = ~_is_space(b)
    prev_nsp = torch.zeros_like(nsp)
    prev_nsp[1:] = nsp[:-1]
    next_nsp = torch.zeros_like(nsp)
    next_nsp[:-1] = nsp[1:]
    start = nsp & ~prev_nsp
    end = nsp & ~next_nsp

    bp = (b + 1) & 0x1FF
    # S[i] = sum_{j<=i} (b[j]+1) * Pinv^j   (u32 wraparound): each term is
    # below 2^41 and N of them below 2^63, so the int64 sum is exact
    s1 = torch.cumsum(torch.where(nsp, (bp * pki1) & _M32, 0), 0) & _M32
    s2 = torch.cumsum(torch.where(nsp, (bp * pki2) & _M32, 0), 0) & _M32

    # start offset of the token covering position i (valid at end positions)
    tok_start = torch.cummax(torch.where(start, pos, -1), 0).values

    # hash at end position e with token start s:
    #   P^e * (S[e] - S[s-1])  — S[s-1] via gather (s >= 1) or 0 (s == 0)
    sm1 = (tok_start - 1).clamp_min(0)
    s1_prev = torch.where(tok_start > 0, s1[sm1], 0)
    s2_prev = torch.where(tok_start > 0, s2[sm1], 0)
    h1 = _mulu32(pk1, (s1 - s1_prev) & _M32)
    h2 = _mulu32(pk2, (s2 - s2_prev) & _M32)

    # SENTINEL guard: the all-ones pair is reserved for padding rows
    both = (h1 == SENTINEL) & (h2 == SENTINEL)
    h2 = torch.where(both, SENTINEL - 1, h2)
    return h1, h2, tok_start, start, end


def _compact_tokens(h1, h2, tok_start, end, max_tokens: int):
    """Per-end-position rows -> dense ``[max_tokens]`` rows (JAX
    ``_compact_tokens``): ``t_hi``/``t_lo`` int32 u32 bit patterns padded
    with SENTINEL, ``t_start`` int32 padded with INT32_MAX, and
    ``n_tokens`` (int32, every end counted, rows past ``max_tokens``
    dropped)."""
    dev = h1.device
    ends = torch.nonzero(end).flatten()[:max_tokens]
    k = ends.shape[0]
    t_hi = torch.full((max_tokens,), SENTINEL, dtype=torch.int64, device=dev)
    t_lo = torch.full((max_tokens,), SENTINEL, dtype=torch.int64, device=dev)
    t_start = torch.full((max_tokens,), _INT32_MAX, dtype=torch.int32,
                         device=dev)
    t_hi[:k] = h1[ends]
    t_lo[:k] = h2[ends]
    t_start[:k] = tok_start[ends].to(torch.int32)
    n_tokens = end.sum(dtype=torch.int32)
    return (t_hi.to(torch.int32), t_lo.to(torch.int32), t_start, n_tokens)


def tokenize_compact_plain(chunk: torch.Tensor, max_tokens: int):
    """Plain PyTorch form of the kernel: :func:`tokenize_hash` +
    :func:`_compact_tokens` over a padded ``[N]`` uint8 chunk.  Returns
    ``(t_hi, t_lo, t_start, n_tokens)`` as :func:`_compact_tokens`."""
    tables = _device_tables(chunk.shape[0], str(chunk.device))
    h1, h2, tok_start, _start, end = tokenize_hash(chunk, *tables)
    return _compact_tokens(h1, h2, tok_start, end, max_tokens)


@functools.cache
def _library() -> ctypes.CDLL:
    from map_oxidize_tpu_torch.ops.build import load

    return bind_library(load(_LIB))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a built ``tokenize_compact.cu`` on
    ``lib`` and returns it."""
    lib.moxt_tokenize_compact_scratch.argtypes = [ctypes.c_longlong]
    lib.moxt_tokenize_compact_scratch.restype = ctypes.c_longlong
    lib.moxt_tokenize_compact.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.moxt_tokenize_compact.restype = ctypes.c_int
    lib.moxt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.moxt_cuda_error_string.restype = ctypes.c_char_p
    lib.moxt_tokenize_compact_layout.argtypes = [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.moxt_tokenize_compact_layout.restype = None
    return lib


def _layout(threads: int, bytes_per_thread: int, **more) -> dict:
    return {"threads": threads, "bytes_per_thread": bytes_per_thread,
            "tile": threads * bytes_per_thread, **more}


@functools.cache
def source_layout() -> dict:
    """The kernel's launch layout as its source declares it, read without
    building it: ``threads`` per block, ``bytes_per_thread`` and ``tile``
    (bytes per block).  Tests place tokens on these edges;
    :func:`built_layout` is the built library's own word."""
    import re

    from map_oxidize_tpu_torch.ops.build import CSRC

    src = (CSRC / f"{_LIB}.cu").read_text()
    found = {}
    for name in ("THREADS", "BYTES_PER_THREAD"):
        m = re.search(rf"^constexpr int {name} = (\d+);", src, re.M)
        if m is None:
            raise RuntimeError(f"{_LIB}.cu declares no {name}")
        found[name] = int(m.group(1))
    return _layout(found["THREADS"], found["BYTES_PER_THREAD"])


def built_layout() -> dict:
    """The built kernel's launch layout: :func:`source_layout`'s keys and
    ``dynamic_smem_bytes`` per block.  Builds the library (needs ``nvcc``)."""
    vals = [ctypes.c_int() for _ in range(3)]
    _library().moxt_tokenize_compact_layout(*(ctypes.byref(v) for v in vals))
    threads, per_thread, smem = (v.value for v in vals)
    return _layout(threads, per_thread, dynamic_smem_bytes=smem)


def tokenize_compact(chunk: torch.Tensor, max_tokens: int):
    """Dense token rows of a padded ``[N]`` uint8 chunk: ``(t_hi, t_lo,
    t_start, n_tokens)`` as :func:`tokenize_compact_plain` returns them.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel on the current stream, without synchronising, and adds one to
    ``tokenize_compact.launches``."""
    if chunk.device.type == "cpu":
        return tokenize_compact_plain(chunk, max_tokens)
    if chunk.device.type != "cuda":
        raise ValueError(f"no kernel for device {chunk.device}")
    if (chunk.dtype != torch.uint8 or chunk.ndim != 1
            or not chunk.is_contiguous() or chunk.data_ptr() % 16):
        raise ValueError("chunk must be a contiguous, 16-byte aligned 1-d "
                         "uint8 tensor")
    if max_tokens < 1 or max_tokens > _INT32_MAX:
        raise ValueError(f"max_tokens must be in [1, 2^31), got {max_tokens}")
    n = chunk.shape[0]
    if n >= _INT32_MAX:
        raise ValueError(f"chunk of {n} bytes: offsets must fit int32")
    dev = chunk.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _library()
    scratch = torch.empty(lib.moxt_tokenize_compact_scratch(n),
                          dtype=torch.uint8, device=dev)
    t_hi = torch.empty(max_tokens, dtype=torch.int32, device=dev)
    t_lo = torch.empty(max_tokens, dtype=torch.int32, device=dev)
    t_start = torch.empty(max_tokens, dtype=torch.int32, device=dev)
    n_tokens = torch.empty((), dtype=torch.int32, device=dev)
    rc = lib.moxt_tokenize_compact(
        index, chunk.data_ptr(), n, max_tokens, scratch.data_ptr(),
        t_hi.data_ptr(), t_lo.data_ptr(), t_start.data_ptr(),
        n_tokens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"tokenize_compact launch failed (n={n}, max_tokens="
            f"{max_tokens}): {lib.moxt_cuda_error_string(rc).decode()}")
    tokenize_compact.launches += 1
    return t_hi, t_lo, t_start, n_tokens


#: launches of the CUDA kernel in this process
tokenize_compact.launches = 0


def _dedup_chunk(t_hi, t_lo, t_start, out_keys: int):
    """Sort token rows by key; per unique key emit (count, min start) (JAX
    ``_dedup_chunk``).

    The two-plane sort is one sort of int64 order keys; the segment
    reductions are integer scatters (exact, in any order).  Returns dense
    ``[out_keys]`` arrays (unique keys compacted to the front, SENTINEL
    padding; planes as int32 bit patterns), ``n_unique`` and
    ``n_dropped`` (uniques past ``out_keys``: nonzero means the chunk-key
    capacity must grow)."""
    m = t_hi.shape[0]
    dev = t_hi.device
    keys, order = torch.sort(keys_from_plane_tensors(t_hi, t_lo))
    start_s = t_start[order]
    new_seg = torch.ones(m, dtype=torch.bool, device=dev)
    new_seg[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(new_seg, 0) - 1
    n_seg = seg[-1] + 1
    ones = (keys != SENTINEL_KEY).to(torch.int32)
    counts = torch.zeros(m, dtype=torch.int32, device=dev).scatter_add_(
        0, seg, ones)
    reps = torch.full((m,), _INT32_MAX, dtype=torch.int32,
                      device=dev).scatter_reduce_(0, seg, start_s, "amin")
    # every row of a segment holds the same key, so any write order is right
    ukeys = torch.full((m,), SENTINEL_KEY, dtype=torch.int64,
                       device=dev).scatter_(0, seg, keys)
    pad_seg = ukeys[n_seg - 1] == SENTINEL_KEY
    n_unique = n_seg - pad_seg.to(torch.int64)
    live = torch.arange(m, device=dev) < n_unique
    ukeys = torch.where(live, ukeys, SENTINEL_KEY)
    counts = torch.where(live, counts, 0)
    reps = torch.where(live, reps, _INT32_MAX)
    n_dropped = (n_unique - out_keys).clamp_min(0)
    u_hi, u_lo = plane_tensors_from_keys(ukeys)
    return (u_hi[:out_keys], u_lo[:out_keys], counts[:out_keys],
            reps[:out_keys], n_unique, n_dropped)


def _ngram_rows(t_hi, t_lo, t_start, n_tokens, ngram: int):
    """Compose token rows into n-gram rows (JAX ``_ngram_rows``): row j
    covers tokens ``[j, j+ngram)`` (in-chunk adjacency, the host bigram
    mapper's semantics — pairs never straddle chunks).  The key mixes the
    member tokens' planes with odd multipliers; the host recovers the
    string from the representative start (:func:`ngram_at`)."""
    if ngram == 1:
        return t_hi, t_lo, t_start, n_tokens
    m = t_hi.shape[0]
    dev = t_hi.device
    hi, lo = _u32(t_hi), _u32(t_lo)
    g_hi, g_lo = hi, lo
    for k in range(1, ngram):
        pad = torch.full((k,), SENTINEL, dtype=torch.int64, device=dev)
        g_hi = (_mulu32(g_hi, _NG1) + torch.cat([hi[k:], pad])) & _M32
        g_lo = (_mulu32(g_lo, _NG2) + torch.cat([lo[k:], pad])) & _M32
    n_grams = (n_tokens - (ngram - 1)).clamp_min(0)
    live = torch.arange(m, device=dev) < n_grams
    g_hi = torch.where(live, g_hi, SENTINEL)
    g_lo = torch.where(live, g_lo, SENTINEL)
    g_start = torch.where(live, t_start, _INT32_MAX)
    # padding guard: a live n-gram must never alias the SENTINEL pair
    both = (g_hi == SENTINEL) & (g_lo == SENTINEL)
    g_lo = torch.where(live & both, SENTINEL - 1, g_lo)
    return g_hi.to(torch.int32), g_lo.to(torch.int32), g_start, n_grams


def tokenize_count_core(chunk: torch.Tensor, max_tokens: int,
                        out_keys: int, fetch_keys: int, ngram: int = 1):
    """The fused device map for one padded ``[N]`` uint8 chunk (JAX
    ``tokenize_count_core`` / ``tokenize_count_chunk``): bytes -> per-unique
    -key ``(u_hi, u_lo, counts, reps)`` plus ``packed``, one int32 array of
    u32 bit patterns carrying ``(n_unique, n_dropped, n_records)`` and the
    first ``fetch_keys`` (hi, lo, rep) rows, so the host's dictionary
    update is a single fetch.  ``ngram > 1`` counts in-chunk adjacent
    token n-grams instead of single tokens."""
    t_hi, t_lo, t_start, n_tokens = tokenize_compact(chunk, max_tokens)
    t_hi, t_lo, t_start, n_records = _ngram_rows(
        t_hi, t_lo, t_start, n_tokens, ngram)
    u_hi, u_lo, counts, reps, n_unique, n_dropped = _dedup_chunk(
        t_hi, t_lo, t_start, out_keys)
    f = fetch_keys
    packed = torch.cat([
        torch.stack([n_unique.to(torch.int32), n_dropped.to(torch.int32),
                     n_records.to(torch.int32)]),
        u_hi[:f], u_lo[:f], reps[:f],
    ])
    return u_hi, u_lo, counts, reps, packed


#: :func:`tokenize_count_core` under the launch ledger (JAX
#: ``ops/device_tokenize.py:236``)
tokenize_count_chunk = observed("device_map/tokenize", tokenize_count_core)


def pad_chunk(chunk: bytes, n: int) -> np.ndarray:
    """Chunk bytes -> the kernel's fixed [n] uint8 window, space-padded
    (spaces yield no tokens, so no valid-length scalar rides along)."""
    if len(chunk) > n:
        raise ValueError(f"chunk of {len(chunk)} bytes exceeds {n}")
    arr = np.frombuffer(chunk, np.uint8)
    if len(chunk) < n:
        arr = np.concatenate([arr, np.full(n - len(chunk), 32, np.uint8)])
    return arr


class DeviceTokenizer:
    """Host-side wrapper: pads a chunk, copies it to ``device`` and runs
    :func:`tokenize_count_core` (JAX ``DeviceTokenizer``).  ``device=None``
    is the CUDA card, and raises without one; the CPU only when asked for.
    A device-map job stages its chunks through a pinned ring instead
    (``runtime/device_map.py``) and calls :meth:`map_padded`."""

    def __init__(self, chunk_bytes: int, out_keys: int = 1 << 19,
                 device=None, fetch_keys: int = 1 << 16, ngram: int = 1):
        self.n = chunk_bytes
        self.max_tokens = chunk_bytes // 2 + 1
        # the kernel can emit at most max_tokens unique rows; out_keys beyond
        # that would desync the host's packed-array slicing from the kernel's
        # actual (clamped) output width
        self.out_keys = min(out_keys, self.max_tokens)
        self.fetch_keys = min(fetch_keys, self.out_keys)
        if device is None:
            from map_oxidize_tpu_torch.runtime.engine import pick_device

            device = pick_device("cuda")
        self.device = torch.device(device)
        self.ngram = ngram

    def pad_chunk(self, chunk: bytes) -> np.ndarray:
        return pad_chunk(chunk, self.n)

    def map_padded(self, dev: torch.Tensor):
        """``(u_hi, u_lo, counts, reps, packed)`` of one padded chunk
        already on the device."""
        return tokenize_count_chunk(dev, max_tokens=self.max_tokens,
                                    out_keys=self.out_keys,
                                    fetch_keys=self.fetch_keys,
                                    ngram=self.ngram)

    def map_chunk_device(self, chunk: bytes):
        """Device tensors ``(u_hi, u_lo, counts, reps, packed)`` for one
        chunk of at most ``chunk_bytes``."""
        arr = self.pad_chunk(chunk).copy()  # frombuffer views are read-only
        return self.map_padded(torch.from_numpy(arr).to(self.device))


#: :data:`_WS` as regex classes: a token runs to the next ASCII whitespace
_WS_CLASS = rb"[ \t\n\r\x0b\x0c]"
_TOKEN_CLASS = rb"[^ \t\n\r\x0b\x0c]*"


@functools.lru_cache(maxsize=None)
def _ngram_re(ngram: int) -> re.Pattern:
    """One group per member token, whitespace runs between them."""
    return re.compile(b"(" + _TOKEN_CLASS + b")"
                      + (_WS_CLASS + b"*(" + _TOKEN_CLASS + b")")
                      * (ngram - 1))


def token_at(chunk: bytes, start: int) -> bytes:
    """Slice the (lowercased) token starting at ``start`` in raw chunk bytes
    or a memoryview of them — the host half of dictionary building.  Must
    mirror the device's boundary rule: the token runs to the next ASCII
    whitespace byte."""
    return ngram_at(chunk, start, 1)


def ngram_at(chunk: bytes, start: int, ngram: int) -> bytes:
    """The canonical n-gram string whose first token starts at ``start``:
    member tokens joined by ONE space (the host mappers' key format —
    ``"tok1 tok2"`` — regardless of the whitespace actually between them).
    A token cut by the chunk's end is what the chunk holds of it.  One
    regex match, which reads a memoryview as fast as bytes and copies out
    only the tokens."""
    return b" ".join(_ngram_re(ngram).match(chunk, start).groups()).lower()
