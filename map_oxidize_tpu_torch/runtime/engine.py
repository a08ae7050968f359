"""Streaming device reduce engine (single device).

The port of the JAX package's ``runtime/engine.py`` fold engine: a
device-resident accumulator of reduced ``(key, value)`` rows, into which
mapped batches fold as they stream in:

    host map -> pad to a fixed batch -> copy to the device ->
    sort + segment-combine (ops.segment_reduce)

Keys live on the device as int64 order keys (see
:mod:`map_oxidize_tpu_torch.ops.segment_reduce`).  PyTorch launches
asynchronously, so host tokenization of chunk N overlaps the device's
reduction of chunk N-1 without extra machinery; the host syncs only at the
periodic overflow poll, at a capacity-growth decision the host bound cannot
settle, and at finalize.

Engine contract for ``finalize()``: returns ``(hi, lo, vals, n_unique)``
numpy arrays where rows whose key is SENTINEL are padding; consumers mask on
the sentinel.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from map_oxidize_tpu_torch.api import MapOutput, Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.ops.segment_reduce import (
    SENTINEL_KEY,
    _identity,
    keys_from_planes,
    make_accumulator,
    merge_batch_into_accumulator,
    merge_into_accumulator,
    pack_accumulator_state,
    planes_from_keys,
    torch_dtype,
)
from map_oxidize_tpu_torch.ops.topk import top_k_pairs
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


class CapacityError(RuntimeError):
    """Keys were dropped: distinct keys exceeded the accumulator's maximum
    capacity; re-run with a larger ``key_capacity``."""


def pick_device(backend: str = "cuda") -> torch.device:
    """Resolve the compute device: 'cuda' demands a CUDA device and raises
    when there is none; 'cpu' is the CPU, and only when asked for."""
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'cuda' requested but no CUDA device is available "
                "(pass backend='cpu' to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "cpu":
        return torch.device("cpu")
    raise ValueError(f"backend must be cuda|cpu, got {backend!r}")


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


class StreamingEngineBase(abc.ABC):
    """Shared host-side surface: batch padding, the feed loop, capacity
    growth and the health-check cadence.  Subclasses own the device state.

    Batch sizing: rows are fed in slices of at most ``feed_batch``, each
    padded up to the next power of two (at least 512), so a handful of
    shapes serve every chunk and a short chunk does not pay full-batch sort
    cost.

    Capacity growth: the accumulator starts at ``initial_key_capacity`` and
    grows by sentinel-pad steps toward ``key_capacity`` (the hard max),
    *before* a merge could overflow, driven by a host-tracked upper bound on
    live keys.  The bound is refreshed from the device's exact count only
    when it would otherwise force a growth.  Past ``key_capacity`` merges
    drop keys — counted by a cumulative device-side counter that the health
    check turns into :class:`CapacityError` (an exactly-full accumulator is
    NOT an error; only actual drops are).
    """

    feed_batch: int
    capacity: int
    max_capacity: int

    def __init__(self, config: JobConfig, reducer: Reducer,
                 value_shape: tuple = (), value_dtype=np.int32,
                 overflow_check_every: int = 64):
        self.config = config
        self.combine = reducer.combine
        self.value_shape = tuple(value_shape)
        self.value_dtype = np.dtype(value_dtype)
        self._pad_val = _identity(self.combine, self.value_dtype)
        self._merges = 0
        self._check_every = overflow_check_every
        self.rows_fed = 0
        self._stage: list = []   # host-side staging of mapped rows
        self._staged = 0
        self._n_unique = None    # device live-key count (0-d tensor)
        self._n_live_ub = 0      # host upper bound on live keys
        self._total_hint = None  # exact cap on distinct keys, if known

    def _round_batch(self, n: int) -> int:
        return min(next_pow2(max(n, 512)), self.feed_batch)

    def _pad(self, hi, lo, vals, start, stop):
        """Rows [start:stop) as (int64 order keys, values), padded with
        SENTINEL keys / identity values to the rounded batch shape."""
        b = self._round_batch(stop - start)
        n = stop - start
        keys = np.full(b, SENTINEL_KEY, np.int64)
        p_vals = np.full((b,) + self.value_shape, self._pad_val,
                         self.value_dtype)
        keys[:n] = keys_from_planes(hi[start:stop], lo[start:stop])
        p_vals[:n] = vals[start:stop]
        return keys, p_vals

    def feed(self, out: MapOutput) -> None:
        """Stage one mapped chunk; flush to the device once a full batch of
        rows has gathered."""
        rows = len(out)
        self.rows_fed += rows
        if rows == 0:
            return
        out.ensure_planes()
        self._stage.append((out.hi, out.lo, out.values))
        self._staged += rows
        if self._staged >= self.feed_batch:
            self.flush()

    def flush(self) -> None:
        """Ship all staged rows to the device."""
        if not self._staged:
            return
        if len(self._stage) == 1:
            hi, lo, vals = self._stage[0]
        else:
            hi = np.concatenate([s[0] for s in self._stage])
            lo = np.concatenate([s[1] for s in self._stage])
            vals = np.concatenate([s[2] for s in self._stage])
        self._stage = []
        self._staged = 0
        for start in range(0, hi.shape[0], self.feed_batch):
            stop = min(start + self.feed_batch, hi.shape[0])
            self._merge_batch(self._pad(hi, lo, vals, start, stop))
            self._merges += 1
            if self._merges % self._check_every == 0:
                self._check_health()

    def hint_total_keys(self, n: int) -> None:
        """The job-wide distinct-key count can never exceed ``n`` (e.g. the
        host dictionary's size): rules out over-growth and growth syncs."""
        self._total_hint = n

    def _ensure_capacity(self, incoming: int) -> None:
        if self.capacity >= self.max_capacity:
            return
        needed = self._n_live_ub + incoming
        if self._total_hint is not None:
            needed = min(needed, self._total_hint)
        if needed <= self.capacity:
            return
        if self._n_unique is not None:
            # growth looks necessary: refresh the bound from the device
            # first (the only sync on the feed path)
            self._n_live_ub = self._read_live()
            needed = self._n_live_ub + incoming
            if self._total_hint is not None:
                needed = min(needed, self._total_hint)
        if needed <= self.capacity:
            return
        new_cap = min(self.max_capacity,
                      max(next_pow2(needed), next_pow2(self.capacity + 1)))
        self._apply_grow(new_cap)
        _log.info("accumulator grown %d -> %d rows", self.capacity, new_cap)
        self.capacity = new_cap

    @abc.abstractmethod
    def _read_live(self) -> int:
        """Exact live-key count from the device (sync point)."""

    @abc.abstractmethod
    def _apply_grow(self, new_cap: int) -> None:
        """Extend the device accumulator with SENTINEL rows to ``new_cap``."""

    @abc.abstractmethod
    def _merge_batch(self, padded) -> None:
        """Fold one padded ``(keys, vals)`` batch into device state."""

    @abc.abstractmethod
    def _check_health(self) -> None:
        """Raise if keys were dropped (host sync point)."""

    def finalize(self):
        """Flush staged rows, health-check, and return ``(hi, lo, vals,
        n_unique)`` per the engine contract (SENTINEL rows are padding)."""
        self.flush()
        return self._finalize()

    @abc.abstractmethod
    def _finalize(self):
        """Post-flush finalize; see :meth:`finalize`."""

    @abc.abstractmethod
    def _top_k_device(self, k: int):
        """Device top-k over the accumulator -> (keys_k, vals_k)."""

    def top_k(self, k: int):
        """Device top-k (value-descending, ties to the lower key) over the
        accumulator -> numpy ``(hi, lo, vals)`` plus the distinct-key count.
        Rows past the live count carry SENTINEL keys."""
        if self.value_shape != ():
            raise ValueError("top_k requires scalar values")
        *_, n = self.finalize()
        keys, vals = self._top_k_device(k)
        hi, lo = planes_from_keys(keys)
        return hi, lo, vals.cpu().numpy(), n


class DeviceReduceEngine(StreamingEngineBase):
    """Single-device engine: one accumulator on ``device``, no collectives."""

    def __init__(self, config: JobConfig, reducer: Reducer,
                 value_shape: tuple = (), value_dtype=np.int32, device=None,
                 overflow_check_every: int = 64):
        super().__init__(config, reducer, value_shape, value_dtype,
                         overflow_check_every)
        self.device = (torch.device(device) if device is not None
                       else pick_device(config.backend))
        self.feed_batch = config.batch_size
        self.max_capacity = config.key_capacity
        self.capacity = min(config.initial_key_capacity, self.max_capacity)
        #: full feed batches queued host-side and shipped as ONE stacked
        #: transfer; the merges still run one by one, in feed order
        self.dispatch_batch = max(1, config.dispatch_batch)
        self._queue: list = []
        self._keys, self._vals = make_accumulator(
            self.capacity, self.value_shape, self.value_dtype, self.combine,
            self.device)
        self._ovf = torch.zeros((), dtype=torch.int64, device=self.device)

    def _read_live(self) -> int:
        self._drain()
        return int(self._n_unique)

    def _apply_grow(self, new_cap: int) -> None:
        p_keys, p_vals = make_accumulator(
            new_cap - self.capacity, self.value_shape, self.value_dtype,
            self.combine, self.device)
        self._keys = torch.cat([self._keys, p_keys])
        self._vals = torch.cat([self._vals, p_vals])

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _merge_batch(self, padded) -> None:
        keys, vals = padded
        incoming = keys.shape[0]
        self._ensure_capacity(incoming)
        if self.dispatch_batch > 1 and incoming == self.feed_batch:
            self._queue.append(padded)
            self._n_live_ub += incoming
            if len(self._queue) >= self.dispatch_batch:
                self._drain()
            return
        self._drain()  # merge order = feed order
        self._keys, self._vals, self._n_unique, self._ovf = (
            merge_into_accumulator(self._keys, self._vals, self._ovf,
                                   self._to_device(keys),
                                   self._to_device(vals), self.combine))
        self._n_live_ub += incoming

    def _drain(self) -> None:
        """Ship the queued full batches as one stacked transfer and fold
        them in order."""
        if not self._queue:
            return
        keys = np.stack([q[0] for q in self._queue])
        vals = np.stack([q[1] for q in self._queue])
        self._queue = []
        self._keys, self._vals, self._n_unique, self._ovf = (
            merge_batch_into_accumulator(
                self._keys, self._vals, self._ovf, self._to_device(keys),
                self._to_device(vals), self.combine))

    def export_state(self) -> dict:
        """The reduce state as device tensors plus host counters (the unit
        :mod:`map_oxidize_tpu_torch.convert` translates to and from the JAX
        engine's ``export_state``)."""
        self._drain()
        return {
            "acc_keys": self._keys,
            "acc_vals": self._vals,
            "ovf": self._ovf,
            "n_unique": -1 if self._n_unique is None else int(self._n_unique),
            "n_live_ub": self._n_live_ub,
            "rows_fed": self.rows_fed,
        }

    def import_state(self, st: dict) -> None:
        """Restore an :meth:`export_state` snapshot onto this engine's
        device."""
        self._queue = []
        self._keys = st["acc_keys"].to(self.device)
        self._vals = st["acc_vals"].to(self.device, torch_dtype(
            self.value_dtype))
        self.capacity = int(self._keys.shape[0])
        self._ovf = st["ovf"].to(self.device, torch.int64)
        n = int(st["n_unique"])
        self._n_unique = (None if n < 0 else
                          torch.tensor(n, dtype=torch.int64,
                                       device=self.device))
        self._n_live_ub = int(st["n_live_ub"])
        self.rows_fed = int(st["rows_fed"])

    def _raise_dropped(self, dropped: int) -> None:
        raise CapacityError(
            f"{dropped} distinct keys dropped: accumulator exceeded "
            f"key_capacity={self.max_capacity}; increase key_capacity")

    def _check_health(self) -> None:
        self._drain()
        dropped = int(self._ovf)  # host sync point
        if dropped:
            self._raise_dropped(dropped)

    def _finalize(self):
        self._drain()
        if self._n_unique is None:
            # no merge ever ran: the accumulator is pristine
            return (np.full(self.capacity, SENTINEL, np.uint32),
                    np.full(self.capacity, SENTINEL, np.uint32),
                    np.full((self.capacity,) + self.value_shape,
                            self._pad_val, self.value_dtype), 0)
        if self.value_shape == () and self.value_dtype.itemsize == 4:
            # ONE fetch for keys, values, n_unique and the overflow count
            packed = pack_accumulator_state(
                self._keys, self._vals, self._n_unique,
                self._ovf).cpu().numpy().astype(np.uint32)
            if packed[1, -1]:
                self._raise_dropped(int(packed[1, -1]))
            return (packed[0, :-1], packed[1, :-1],
                    packed[2, :-1].view(self.value_dtype), int(packed[0, -1]))
        self._check_health()
        hi, lo = planes_from_keys(self._keys)
        return hi, lo, self._vals.cpu().numpy(), int(self._n_unique)

    def _top_k_device(self, k: int):
        return top_k_pairs(self._keys, self._vals, min(k, self.capacity))
