"""Inverted-index build (a copy of the JAX package's
``workloads/inverted_index.py``: ``InvertedIndexMapper`` :34,
``inverted_index_model`` :99, ``Postings`` :112,
``postings_from_sorted`` :236, ``make_inverted_index``).

* a **document** is one line of the corpus;
* its **doc id** is the absolute byte offset of its first byte — unique,
  monotone in document order, and computable per chunk without a global
  line counter (chunks are newline-aligned, so every chunk starts a doc);
* the index maps each term (tokenized exactly like word count: whitespace
  split + lowercase) to the ascending list of ids of the documents that
  contain it at least once.

The combine is list concatenation, handled by
:class:`~map_oxidize_tpu_torch.runtime.collect.CollectEngine` (collect all
(term, doc) pairs, one sort, segment boundaries by a vectorized diff).
The map side emits one pair per distinct term per document.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from map_oxidize_tpu_torch.api import Mapper, MapOutput
from map_oxidize_tpu_torch.ops.hashing import HashDictionary, moxt64_bytes, split_u64
from map_oxidize_tpu_torch.workloads.wordcount import tokenize


class InvertedIndexMapper(Mapper):
    """(chunk bytes, base byte offset) -> one (term-hash, doc-id) row per
    distinct term per document.  Values are the doc id's uint32 planes."""

    value_shape = (2,)
    value_dtype = np.uint32
    keys_have_dictionary = True

    def __init__(self, tokenizer: str = "ascii", use_native: bool = True):
        self.tokenizer = tokenizer
        self._native = None
        if use_native and tokenizer == "ascii":
            from map_oxidize_tpu_torch.native import bindings

            self._native = bindings.stream(ngram=1)

    def map_docs(self, chunk, base_doc: int = 0) -> MapOutput:
        if self._native is not None:
            return self._native.map_docs(chunk, base_doc)
        return self._map_docs_python(chunk, base_doc)

    def iter_file_docs(self, path: str, chunk_bytes: int,
                       start_offset: int = 0):
        """Native mmap fast path yielding ``(MapOutput, next_offset)``, or
        None (driver falls back to the splitter + map_docs with host-tracked
        offsets)."""
        if self._native is None:
            return None
        return self._native.iter_file_docs(path, chunk_bytes, start_offset)

    def map_chunk(self, chunk) -> MapOutput:  # Mapper ABC
        raise NotImplementedError(
            "InvertedIndexMapper needs the chunk's base byte offset for doc "
            "identity — use map_docs(chunk, base_doc) or the "
            "run_inverted_index_job driver, not the offset-less map path")

    def _map_docs_python(self, chunk, base_doc: int) -> MapOutput:
        chunk = bytes(chunk)
        d = HashDictionary()
        hashes: list[int] = []
        docs: list[int] = []
        n_tokens = 0
        off = 0
        for line in chunk.split(b"\n"):
            toks = tokenize(line, self.tokenizer)
            n_tokens += len(toks)
            seen = set()
            for t in toks:
                if t not in seen:
                    seen.add(t)
                    h = moxt64_bytes(t)
                    d.add(h, t)
                    hashes.append(h)
                    docs.append(base_doc + off)
            off += len(line) + 1
        h64 = np.array(hashes, np.uint64)
        hi, lo = split_u64(h64)
        du = np.array(docs, np.uint64)
        vals = np.empty((len(docs), 2), np.uint32)
        vals[:, 0] = (du >> np.uint64(32)).astype(np.uint32)
        vals[:, 1] = (du & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return MapOutput(hi=hi, lo=lo, values=vals, dictionary=d,
                         records_in=n_tokens)


def inverted_index_model(path: str) -> dict[bytes, list[int]]:
    """Pure-host oracle: {term: ascending doc-id list}, doc id = line start
    byte offset.  Independent of every engine and mapper under test."""
    index: dict[bytes, set[int]] = {}
    off = 0
    with open(path, "rb") as f:
        for line in f:
            for t in tokenize(line):
                index.setdefault(t, set()).add(off)
            off += len(line)
    return {t: sorted(s) for t, s in index.items()}


class Postings(Mapping):
    """CSR view over the engine's sorted (key, doc) columns: distinct term
    hashes + segment offsets + the shared doc column — the index itself, in
    the columnar form the device produced it.

    A 256MB corpus yields tens of millions of (term, doc) pairs; turning
    them into a dict of Python int lists costs GBs of boxed objects and
    seconds of loop time that most consumers (metrics, doc-frequency top-k,
    the streaming writer) never need.  Like the driver's LazyCounts, this
    Mapping answers everything it can from the arrays and materializes
    per-term lists only on access.
    """

    def __init__(self, terms: np.ndarray, offsets: np.ndarray,
                 docs: np.ndarray, dictionary: HashDictionary):
        #: distinct term hashes.  Sorted within each shard's block but NOT
        #: globally ascending: the sharded engine concatenates its
        #: hash-partitions shard-major, so lookups go through a lazy
        #: hash->row dict, never a binary search.
        self._terms = terms
        #: segment offsets: term i's docs are docs[off[i]:off[i+1]]
        self._offsets = offsets
        self._docs = docs
        self._dict = dictionary
        self._index: dict[int, int] | None = None

    @classmethod
    def from_sorted(cls, keys_sorted: np.ndarray, docs: np.ndarray,
                    dictionary: HashDictionary) -> "Postings":
        """Key-sorted (key, doc) rows -> CSR by boundary detection."""
        bounds = np.flatnonzero(
            np.concatenate([[True], keys_sorted[1:] != keys_sorted[:-1]])
        ) if keys_sorted.shape[0] else np.empty(0, np.int64)
        return cls(keys_sorted[bounds],
                   np.append(bounds, keys_sorted.shape[0]), docs, dictionary)

    # --- array-answerable queries -----------------------------------------

    def __len__(self) -> int:
        return int(self._terms.shape[0])

    @property
    def n_pairs(self) -> int:
        return int(self._docs.shape[0])

    def doc_freqs(self) -> np.ndarray:
        """Per-term document frequency, vectorized (terms in hash order)."""
        return np.diff(self._offsets)

    def top_by_df(self, k: int) -> list[tuple[bytes, int]]:
        """Top-k terms by document frequency (df desc, term asc tie-break);
        strings materialize only for the <= k winners plus boundary ties."""
        from map_oxidize_tpu_torch.ops.topk import top_k_candidate_indices

        if len(self) == 0:
            return []
        df = self.doc_freqs()
        cand = top_k_candidate_indices(df, k)
        lookup = self._dict.lookup
        pairs = [(lookup(int(h)), int(c))
                 for h, c in zip(self._terms[cand].tolist(),
                                 df[cand].tolist())]
        pairs.sort(key=lambda kv: (-kv[1], kv[0]))
        return pairs[:k]

    # --- Mapping protocol (per-term materialization) ----------------------

    def _segment(self, i: int) -> list[int]:
        a, b = int(self._offsets[i]), int(self._offsets[i + 1])
        return self._docs[a:b].tolist()

    def __getitem__(self, term: bytes) -> list[int]:
        if self._index is None:
            self._index = {h: i for i, h in enumerate(self._terms.tolist())}
        try:
            i = self._index[moxt64_bytes(term)]
        except KeyError:
            raise KeyError(term) from None
        return self._segment(i)

    def __iter__(self):
        lookup = self._dict.lookup
        for h in self._terms.tolist():
            yield lookup(h)

    def items(self):
        """Re-iterable lazy view (NOT a one-shot generator: the Mapping
        contract allows iterating the same view twice, e.g. a report pass
        after a write pass).  Each iteration materializes one term's doc
        list at a time."""
        return _PostingsItems(self)

    def __eq__(self, other):
        if isinstance(other, Postings):
            other = dict(other.items())
        if not isinstance(other, dict):
            return NotImplemented
        return len(self) == len(other) and all(
            t in other and other[t] == d for t, d in self.items()
        )

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


class _PostingsItems:
    """Lazy, re-iterable (term, doc-list) view over a :class:`Postings`."""

    __slots__ = ("_p",)

    def __init__(self, postings: Postings):
        self._p = postings

    def __len__(self) -> int:
        return len(self._p)

    def __iter__(self):
        p = self._p
        lookup = p._dict.lookup
        for i, h in enumerate(p._terms.tolist()):
            yield lookup(h), p._segment(i)


def postings_from_sorted(keys: np.ndarray, docs: np.ndarray,
                         dictionary: HashDictionary) -> Postings:
    """Sorted (key, doc) rows -> :class:`Postings`.  Boundary detection is a
    vectorized diff, no per-row Python.  (term, doc) pairs are unique by
    construction: the mapper emits each term once per doc and docs never
    straddle chunks — newline-aligned cuts guarantee it."""
    return Postings.from_sorted(keys, docs, dictionary)


def make_inverted_index(tokenizer: str = "ascii", use_native: bool = True):
    return InvertedIndexMapper(tokenizer, use_native)
