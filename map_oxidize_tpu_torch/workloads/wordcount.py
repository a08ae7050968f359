"""Word count: whitespace-split, lowercase, no punctuation stripping ("the,"
and "the" are distinct keys).

Two tokenizer modes, as in the JAX package:

* ``ascii`` (default): byte-level — split on ASCII whitespace, lowercase
  ASCII letters (``bytes.split()`` / ``bytes.lower()``).
* ``unicode``: decode UTF-8 and use ``str.split()`` / ``str.lower()``.

The mapper is a *combiner*: it counts within the chunk and emits one row per
distinct token.  Two map paths give the same bytes: the native C++ loop
(``use_native``, :mod:`map_oxidize_tpu_torch.native`), and the Python
``tokenize`` path, whose keys are
:func:`~map_oxidize_tpu_torch.ops.hashing.moxt64_bytes`, the C++ hash
mirrored bit for bit.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from map_oxidize_tpu_torch.api import Mapper, MapOutput, SumReducer
from map_oxidize_tpu_torch.ops.hashing import (
    HashDictionary,
    moxt64_bytes,
    split_u64,
)


def tokenize(chunk, mode: str = "ascii") -> list[bytes]:
    """Split + lowercase per the word-count semantics above."""
    if not isinstance(chunk, bytes):
        chunk = bytes(chunk)  # the splitter yields memoryviews
    if mode == "ascii":
        return chunk.lower().split()
    if mode == "unicode":
        return [t.encode("utf-8") for t in chunk.decode("utf-8").lower().split()]
    raise ValueError(f"unknown tokenizer mode {mode!r}")


class WordCountMapper(Mapper):
    value_shape = ()
    value_dtype = np.int32
    keys_have_dictionary = True

    def __init__(self, tokenizer: str = "ascii", use_native: bool = True):
        self.tokenizer = tokenizer
        self.use_native = use_native
        self._native = None
        if use_native:
            from map_oxidize_tpu_torch.native import bindings

            self._native = bindings.stream(ngram=1, tokenizer=tokenizer)

    def map_file(self, path: str, chunk_bytes: int, start_offset: int = 0):
        """Native mmap fast path: a ``(MapOutput, next_offset)`` generator
        over the file, or None for the Python map (the driver then streams
        the splitter's chunks through ``map_chunk``)."""
        if self._native is None:
            return None
        return self._native.iter_file(path, chunk_bytes, start_offset)

    def map_chunk(self, chunk: bytes) -> MapOutput:
        if self._native is not None:
            # dictionary carries only the delta of newly seen keys — the
            # driver's per-chunk dictionary.update() accumulates the union
            return self._native.map_chunk(chunk)
        toks = tokenize(chunk, self.tokenizer)
        counts = Counter(toks)
        d = HashDictionary()
        hashes = np.empty(len(counts), np.uint64)
        values = np.empty(len(counts), np.int32)
        for i, (tok, c) in enumerate(counts.items()):
            h = moxt64_bytes(tok)
            d.add(h, tok)
            hashes[i] = h
            values[i] = c
        hi, lo = split_u64(hashes)
        return MapOutput(hi=hi, lo=lo, values=values, dictionary=d,
                         records_in=len(toks))


def make_wordcount(tokenizer: str = "ascii", use_native: bool = True):
    """(mapper, reducer) pair for the word-count workload."""
    return WordCountMapper(tokenizer, use_native), SumReducer()
