"""Bigram count (a copy of the JAX package's ``workloads/bigram.py``:
``RescanDictionary`` :27, ``BigramMapper`` :87, ``make_bigram``):
adjacent token pairs *within a chunk's token stream*, key string
``"tok1 tok2"``.

Key cardinality is of order |V|^2 rather than |V|, and keys are longer;
compound keys are just another 64-bit hash.

Pairs that straddle a chunk boundary are not counted, so results are a
function of the chunking (deterministic for a given config).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from map_oxidize_tpu_torch.api import Mapper, MapOutput, SumReducer
from map_oxidize_tpu_torch.ops.hashing import HashDictionary, moxt64_bytes, split_u64
from map_oxidize_tpu_torch.workloads.wordcount import tokenize


class RescanDictionary(HashDictionary):
    """Strings-on-demand dictionary for the hash-only map path.

    In hash-only mode the map emits raw n-gram hashes and NO key bytes — the
    millions of distinct pair strings a wide-key corpus carries are exactly
    what made the map loop DRAM-bound and the per-chunk dictionary drain the
    finalize tax.  But strings are only ever needed for the <= top-k winners
    (plus boundary ties) or a requested full text output, and every counted
    key occurs in the corpus: ONE extra native scan with the same chunk cuts
    recovers the bytes for any queried hash set (and byte-compares repeat
    occurrences, so collisions involving surfaced keys are still detected).

    ``prefetch(hashes)`` resolves what is not yet known; consumers that need
    strings (LazyCounts.top_k, materialization) call it with exactly the
    hashes they are about to look up.
    """

    __slots__ = ("_stream", "_path", "_chunk_bytes", "_early_stop")

    def __init__(self, stream, path: str, chunk_bytes: int,
                 early_stop: bool = True):
        super().__init__()
        self._stream = stream
        self._path = path
        self._chunk_bytes = chunk_bytes
        #: stop the rescan once every queried hash has been seen (top-k
        #: winners are the most frequent keys, so this typically ends within
        #: the first chunks); config.rescan_full=True forces the whole-corpus
        #: scan, which extends the collision byte-check to every occurrence
        self._early_stop = early_stop

    def prefetch(self, hashes) -> None:
        hashes = np.asarray(hashes, np.uint64)
        if hashes.size == 0:
            return
        known = self.materialized()
        if known:
            missing = hashes[[int(h) not in known for h in hashes.tolist()]] \
                if hashes.size <= 64 else \
                hashes[~np.isin(hashes,
                                np.fromiter(known.keys(), np.uint64,
                                            count=len(known)))]
        else:
            missing = hashes
        if missing.size == 0:
            return
        h, lens, blob = self._stream.resolve_file(
            self._path, self._chunk_bytes, np.unique(missing),
            early_stop=self._early_stop)
        self.add_arrays(h, lens, blob)
        self._flush()

    def lookup(self, h: int) -> bytes:
        try:
            return super().lookup(h)
        except KeyError:
            self.prefetch(np.array([h], np.uint64))
            return super().lookup(h)


class BigramMapper(Mapper):
    value_shape = ()
    value_dtype = np.int32
    keys_have_dictionary = True
    wide_keys = True  # distinct pairs ~ |V|^2: collect-reduce territory

    def __init__(self, tokenizer: str = "ascii", use_native: bool = True):
        self.tokenizer = tokenizer
        self._native = None
        #: set by the driver when the engine is the host collect-reduce:
        #: map emits raw hashes only; strings resolve by rescan on demand
        self.hash_only = False
        if use_native:
            from map_oxidize_tpu_torch.native import bindings

            self._native = bindings.stream(ngram=2,
                                                   tokenizer=tokenizer)

    @property
    def supports_hash_only(self) -> bool:
        return self._native is not None

    def rescan_dictionary(self, path: str, chunk_bytes: int,
                          early_stop: bool = True) -> RescanDictionary:
        return RescanDictionary(self._native, path, chunk_bytes, early_stop)

    def map_file(self, path: str, chunk_bytes: int, start_offset: int = 0):
        """Native mmap fast path (see WordCountMapper.map_file)."""
        if self._native is None:
            return None
        if self.hash_only:
            return self._native.iter_file_hashes(path, chunk_bytes,
                                                 start_offset)
        return self._native.iter_file(path, chunk_bytes, start_offset)

    def map_chunk(self, chunk: bytes) -> MapOutput:
        if self._native is not None:
            return self._native.map_chunk(chunk)
        toks = tokenize(chunk, self.tokenizer)
        pairs = Counter(
            toks[i] + b" " + toks[i + 1] for i in range(len(toks) - 1)
        )
        d = HashDictionary()
        hashes = np.empty(len(pairs), np.uint64)
        values = np.empty(len(pairs), np.int32)
        for i, (key, c) in enumerate(pairs.items()):
            h = moxt64_bytes(key)
            d.add(h, key)
            hashes[i] = h
            values[i] = c
        hi, lo = split_u64(hashes)
        return MapOutput(hi=hi, lo=lo, values=values, dictionary=d,
                         records_in=max(len(toks) - 1, 0))


def make_bigram(tokenizer: str = "ascii", use_native: bool = True):
    return BigramMapper(tokenizer, use_native), SumReducer()
