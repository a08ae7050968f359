"""Word count: whitespace-split, lowercase, no punctuation stripping ("the,"
and "the" are distinct keys).

Two tokenizer modes, as in the JAX package:

* ``ascii`` (default): byte-level — split on ASCII whitespace, lowercase
  ASCII letters (``bytes.split()`` / ``bytes.lower()``).
* ``unicode``: decode UTF-8 and use ``str.split()`` / ``str.lower()``.

The mapper is a *combiner*: it counts within the chunk and emits one row per
distinct token.  This slice ports the Python map path only; its keys are
:func:`~map_oxidize_tpu_torch.ops.hashing.moxt64_bytes`, which mirrors the JAX
package's C++ hash bit for bit, so the output bytes match that package's
native path too.
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

    def __init__(self, tokenizer: str = "ascii"):
        self.tokenizer = tokenizer

    def map_chunk(self, chunk: bytes) -> MapOutput:
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


def make_wordcount(tokenizer: str = "ascii"):
    """(mapper, reducer) pair for the word-count workload."""
    return WordCountMapper(tokenizer), SumReducer()
