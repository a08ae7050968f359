"""The user-facing Mapper / Reducer boundary (a copy of the JAX package's
``api`` module, so the port imports nothing from it).

Workloads plug in a ``Mapper`` (host-side, bytes -> hashed key/value arrays)
and a ``Reducer`` (a named associative-commutative monoid the device engine
folds with).  The mapper's contract is already tensorized — it emits NumPy
arrays of (hash-hi, hash-lo, value) plus a host-side hash->bytes dictionary —
so the engine never sees strings.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from map_oxidize_tpu_torch.ops.hashing import HashDictionary


@dataclass
class MapOutput:
    """One mapped chunk, ready for the device.

    ``hi``/``lo``: uint32 key-hash planes, ``values``: ``[n]`` or ``[n, d]``
    array, ``dictionary``: hash -> token bytes for readback (may be empty for
    integer-keyed workloads such as k-means).

    The hash-only map path emits the compact form instead: ``keys64`` set,
    ``hi``/``lo``/``values`` None (values implicitly all-ones counts).  At
    34M pairs the skipped plane split + ones materialization is ~0.5 s of
    host time per 256MB corpus; consumers that need the planes (the
    checkpoint spill format, device engines) call :meth:`ensure_planes`.
    """

    hi: np.ndarray | None
    lo: np.ndarray | None
    values: np.ndarray | None
    dictionary: HashDictionary = field(default_factory=HashDictionary)
    #: number of raw input records the mapper consumed (tokens, points, ...);
    #: powers the Σvalues == Σinputs conservation checks and throughput metrics.
    records_in: int = 0
    #: optional joined uint64 keys (hi << 32 | lo).  Mappers that already
    #: hold the 64-bit form may pass it so host-side engines skip the
    #: join; device engines ignore it (they consume the 32-bit planes).
    keys64: np.ndarray | None = None
    #: optional joined int64 doc ids (pair outputs, compact form): the
    #: host collect engine consumes these directly; ``values`` then stays
    #: None until a plane-bound consumer materializes the (n, 2) uint32
    #: doc planes via :meth:`ensure_planes`.
    docs64: np.ndarray | None = None

    def __len__(self) -> int:
        if self.hi is not None:
            return int(self.hi.shape[0])
        return int(self.keys64.shape[0])

    def ensure_planes(self) -> None:
        """Materialize ``hi``/``lo`` (and ``values``: the (n, 2) doc planes
        for pair outputs, implicit all-ones counts otherwise) from the
        compact 64-bit form for consumers bound to the plane contract."""
        if self.hi is None:
            from map_oxidize_tpu_torch.ops.hashing import split_u64

            self.hi, self.lo = split_u64(self.keys64)
        if self.values is None:
            if self.docs64 is not None:
                du = self.docs64.view(np.uint64)
                v = np.empty((len(self), 2), np.uint32)
                v[:, 0] = (du >> np.uint64(32)).astype(np.uint32)
                v[:, 1] = (du & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                self.values = v
            else:
                self.values = np.ones(len(self), np.int32)


class Mapper(abc.ABC):
    """Host-side map: chunk bytes -> hashed key/value arrays.

    Equivalent of the reference's ``count_words`` (main.rs:94-101), but
    pre-aggregation inside the chunk is the mapper's choice — emitting one row
    per *distinct* key per chunk (a combiner, which the reference effectively
    does by using a HashMap) shrinks host->HBM traffic by the chunk's
    duplication factor.
    """

    #: shape of one value row ((),) scalar by default; k-means uses (d+1,)
    value_shape: tuple = ()
    value_dtype = np.int32
    #: True when every emitted key appears in the chunk's dictionary (string
    #: keyed workloads).  Lets the driver pass the dictionary's exact size to
    #: the engine as a distinct-key bound (no growth syncs, no over-growth).
    keys_have_dictionary: bool = False
    #: True when Σ emitted values == records_in (count-shaped mappers).  The
    #: driver's conservation check applies only to sum-reduced mappers with
    #: this property; set False for sum-of-measurements workloads.
    conserves_counts: bool = True
    #: True when distinct keys grow with the input (bigram: ~|V|^2) rather
    #: than saturating far below it (word count: |V|).  Steers the engine
    #: choice under ``reduce_mode='auto'``: wide key spaces take the
    #: collect-then-reduce-once engine, whose cost is one sort, instead of
    #: the streaming fold, whose accumulator would grow through many
    #: capacities (one XLA executable each) and re-sort per batch.
    wide_keys: bool = False

    @abc.abstractmethod
    def map_chunk(self, chunk: bytes) -> MapOutput:
        raise NotImplementedError


class Reducer:
    """A named associative-commutative combine monoid.

    The reference's only reducer is integer ``+=`` (main.rs:132-134).  Here the
    monoid name selects the device segment-combine and the identity element
    used for padding rows; anything associative+commutative fits the engine
    (the fold order over batches and shards is not the arrival order).
    """

    name = "sum"

    def __init__(self, combine: str = "sum"):
        if combine not in ("sum", "min", "max"):
            raise ValueError(f"unsupported combine {combine!r}")
        self.combine = combine


class SumReducer(Reducer):
    def __init__(self):
        super().__init__("sum")


class MinReducer(Reducer):
    name = "min"

    def __init__(self):
        super().__init__("min")


class MaxReducer(Reducer):
    name = "max"

    def __init__(self):
        super().__init__("max")
