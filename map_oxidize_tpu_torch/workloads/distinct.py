"""Approximate distinct-token count, HyperLogLog (a copy of the JAX
package's ``workloads/distinct.py``: ``hll_registers``, ``hll_estimate``,
``DistinctMapper``, ``distinct_model``, ``write_distinct_output``,
``make_distinct``).  The workload is the max monoid over a tiny integer
key space:

    map:    token -> (bucket = top-p hash bits, rank = leading-zero count
            of the remaining bits + 1), pre-combined per chunk into at most
            ``m = 2^p`` register rows
    reduce: per-bucket max (on one device the driver folds the rows into a
            dense host register array)
    emit:   harmonic-mean estimator over the m registers (host, O(m))

Token hashing reuses the word-count tokenizer stack: the native HLL scan
(``NativeStream.iter_file_hll``) or the Python tokenize + hash path.
Register extraction is vectorized: a ``bincount`` over
``bucket*64 + rank`` and a per-row max, with a bounded-scratch
``np.maximum.at`` fold above p=16.

Standard HLL estimator (Flajolet et al.): ``alpha_m * m^2 / sum(2^-M_j)``
with linear-counting small-range correction; relative standard error is
``1.04 / sqrt(m)`` (~0.8% at the default p=14).
"""

from __future__ import annotations

import numpy as np

from map_oxidize_tpu_torch.api import Mapper, MapOutput, MaxReducer

#: allowed precision range, shared with config.validate: below 11 the
#: frexp-exactness argument in hll_registers needs 64-p <= 53; above 18
#: the estimator error (~0.2%) is already far below corpus-level noise.
HLL_P_MIN, HLL_P_MAX = 11, 18


def hll_registers(hashes: np.ndarray, p: int) -> np.ndarray:
    """Dense ``(2^p,)`` int32 register array from raw u64 token hashes:
    register j = max rank among hashes whose top-p bits equal j (0 when
    the bucket is empty)."""
    m = 1 << p
    if hashes.size == 0:
        return np.zeros(m, np.int32)
    hashes = np.asarray(hashes, np.uint64)
    buckets = (hashes >> np.uint64(64 - p)).astype(np.int64)
    w = (hashes & np.uint64((1 << (64 - p)) - 1)).astype(np.float64)
    # 64-p <= 60 bits... but exact float64 only to 2^53: for p >= 11 the
    # remainder fits 53 bits and frexp is exact.  frexp exponent is
    # floor(log2(w)) + 1 for w > 0, so rank = (64-p) + 1 - exponent.
    _, exp = np.frexp(w)
    ranks = np.where(w == 0, 64 - p + 1, 64 - p + 1 - exp).astype(np.int64)
    if p > 16:
        # bincount scratch is 64 * 2^p * 8B (134MB at p=18, per concurrent
        # chunk): bound it with the slower in-place fold instead
        regs = np.zeros(m, np.int32)
        np.maximum.at(regs, buckets, ranks.astype(np.int32))
        return regs
    present = np.bincount(buckets * 64 + ranks,
                          minlength=m * 64).reshape(m, 64) > 0
    return (present * np.arange(64, dtype=np.int32)).max(axis=1)


def hll_estimate(registers: np.ndarray) -> float:
    """Harmonic-mean cardinality estimate with the linear-counting
    small-range correction."""
    regs = np.asarray(registers, np.float64)
    m = regs.shape[0]
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-regs))
    if est <= 2.5 * m:
        zeros = int(np.count_nonzero(regs == 0))
        if zeros:
            est = m * np.log(m / zeros)
    return float(est)


class DistinctMapper(Mapper):
    """Chunk bytes -> at most ``2^p`` (bucket, max-rank) register rows.

    ``keys_have_dictionary = False``: buckets are small integers (hi = 0,
    lo = bucket), the same integer-key convention k-means uses — no host
    dictionary, no string readback.
    """

    value_shape = ()
    value_dtype = np.int32
    keys_have_dictionary = False

    def __init__(self, tokenizer: str = "ascii", use_native: bool = True,
                 p: int = 14):
        if not HLL_P_MIN <= p <= HLL_P_MAX:
            raise ValueError(
                f"hll precision must be in [{HLL_P_MIN}, {HLL_P_MAX}], "
                f"got {p}")
        self.tokenizer = tokenizer
        self.p = p
        self._native = None
        if use_native:
            from map_oxidize_tpu_torch.native import bindings

            self._native = bindings.stream(ngram=1,
                                                   tokenizer=tokenizer)

    def _registers_output(self, regs: np.ndarray, n_tokens: int) -> MapOutput:
        """Dense ``(2^p,)`` registers (int32 or uint8) -> sparse MapOutput
        of live (bucket, max-rank) rows."""
        live = np.flatnonzero(regs)
        return MapOutput(hi=np.zeros(live.shape[0], np.uint32),
                         lo=live.astype(np.uint32),
                         values=regs[live].astype(np.int32, copy=False),
                         records_in=n_tokens)

    def map_chunk(self, chunk: bytes) -> MapOutput:
        if self._native is not None:
            regs, n_tokens = self._native.map_chunk_hll(chunk, self.p)
            return self._registers_output(regs, n_tokens)
        from map_oxidize_tpu_torch.ops.hashing import moxt64_bytes
        from map_oxidize_tpu_torch.workloads.wordcount import tokenize

        toks = tokenize(chunk, self.tokenizer)
        hashes = np.fromiter((moxt64_bytes(t) for t in toks),
                             np.uint64, count=len(toks))
        return self._registers_output(hll_registers(hashes, self.p),
                                      len(toks))

    def map_file(self, path: str, chunk_bytes: int, start_offset: int = 0):
        """Native mmap fast path: the C++ scan max-folds (bucket, rank)
        into the ``2^p`` registers in-loop — no hash buffer, no host-side
        extraction (the round-4 NumPy bincount held distinct to ~170 MB/s
        against the 544-589 MB/s hash-only scan)."""
        if self._native is None:
            return None

        def _iter():
            for regs, n_tokens, off in self._native.iter_file_hll(
                    path, chunk_bytes, self.p, start_offset):
                yield self._registers_output(regs, n_tokens), off

        return _iter()


def distinct_model(chunks, tokenizer: str = "ascii") -> int:
    """Exact oracle: distinct lowercased tokens across all chunks (the
    number HLL approximates), reference tokenize semantics."""
    from map_oxidize_tpu_torch.workloads.wordcount import tokenize

    seen = set()
    for chunk in chunks:
        seen.update(tokenize(chunk, tokenizer))
    return len(seen)


def write_distinct_output(path: str, regs: np.ndarray, estimate: float,
                          p: int) -> None:
    """Atomic distinct-result writer, shared by the single-process driver
    and the distributed runner (registers max-merge exactly, so both write
    byte-identical files).  ``.npy``: the raw registers — the mergeable
    artifact (np.maximum of two runs' registers estimates the union).
    Anything else: a deterministic text summary."""
    import os

    tmp = f"{path}.tmp.{os.getpid()}"
    if path.endswith(".npy"):
        with open(tmp, "wb") as f:
            np.save(f, regs)
    else:
        with open(tmp, "w") as f:
            f.write(f"estimate\t{estimate:.1f}\n"
                    f"precision\t{p}\n"
                    f"registers_filled\t{int(np.count_nonzero(regs))}\n")
    os.replace(tmp, path)


def make_distinct(tokenizer: str = "ascii", use_native: bool = True,
                  p: int = 14):
    return DistinctMapper(tokenizer, use_native, p), MaxReducer()
