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

Observability seams (the JAX package's ``runtime/engine.py:74-97``,
``:222-236``, ``:275-309``): with ``engine.obs`` set, every flush is an
``engine/flush`` span and lands in ``engine/flush_ms``, ``engine/flushes``
and ``engine/device_put_bytes``; growth counts ``engine/grows`` and sets
``engine/capacity_rows``; the host syncs on the feed path are timed into
``engine/growth_sync_ms`` and ``engine/health_sync_ms``.  The finalize
fetch, which blocks on the whole accumulated device chain, is timed into
the current job's ``device/compute_ms``, and a device resolve inside a
phase into its ``attrib/init_ms``.  The device programs (``engine/merge``,
``engine/merge_packed``, ``engine/merge_packed_batch``,
``engine/grow_concat``, ``engine/pack_finalize``, ``engine/top_k``) run
under the launch ledger (:mod:`map_oxidize_tpu_torch.obs.compile`).
"""

from __future__ import annotations

import abc
import contextlib
import time

import numpy as np
import torch

from map_oxidize_tpu_torch.api import MapOutput, Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import observe_device_wait
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.obs.context import current_obs
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.ops.segment_reduce import (
    _identity,
    keys_from_plane_tensors,
    keys_from_planes,
    make_accumulator,
    merge,
    merge_packed,
    merge_packed_batch,
    pack_finalize,
    planes_from_keys,
    torch_dtype,
)
from map_oxidize_tpu_torch.ops.topk import top_k
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


class CapacityError(RuntimeError):
    """Keys were dropped: distinct keys exceeded the accumulator's maximum
    capacity; re-run with a larger ``key_capacity``."""


def pick_device(backend: str = "cuda") -> torch.device:
    """Resolve the compute device: 'cuda' demands a CUDA device and raises
    when there is none; 'cpu' is the CPU, and only when asked for.

    The first CUDA resolve of a process initialises the CUDA context; when
    a job phase is open, the resolve is timed into the recording job's
    ``attrib/init_ms`` (the attribution's ``setup`` bucket), as the JAX
    package times its first ``jax.devices()``.  A resolve before the first
    phase is already inside ``attrib/pre_phase_ms``.  The CPU resolve
    touches no CUDA."""
    t0 = time.perf_counter()
    try:
        if backend == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'cuda' requested but no CUDA device is "
                    "available (pass backend='cpu' to run on the CPU)")
            return torch.device("cuda", torch.cuda.current_device())
        if backend == "cpu":
            from map_oxidize_tpu_torch.obs.calib import note_cpu_device

            note_cpu_device()
            return torch.device("cpu")
        raise ValueError(f"backend must be cuda|cpu, got {backend!r}")
    finally:
        obs = current_obs()
        if obs is not None and obs.current_phase:
            obs.registry.count("attrib/init_ms",
                               (time.perf_counter() - t0) * 1e3)



def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


@observed("engine/grow_concat")
def _grow_concat(keys, vals, p_keys, p_vals):
    return torch.cat([keys, p_keys]), torch.cat([vals, p_vals])


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

    #: shards: one (the sharded engine sets the mesh's)
    S = 1

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
        #: the job's ``Obs`` bundle, set by the driver (None: no records)
        self.obs = None

    def _round_batch(self, n: int) -> int:
        return min(next_pow2(max(n, 512)), self.feed_batch)

    def _pad(self, hi, lo, vals, start, stop):
        """Rows [start:stop) as (hi, lo, values) host planes, padded with
        SENTINEL keys / identity values to the rounded batch shape."""
        b = self._round_batch(stop - start)
        n = stop - start
        p_hi = np.full(b, SENTINEL, np.uint32)
        p_lo = np.full(b, SENTINEL, np.uint32)
        p_vals = np.full((b,) + self.value_shape, self._pad_val,
                         self.value_dtype)
        p_hi[:n] = hi[start:stop]
        p_lo[:n] = lo[start:stop]
        p_vals[:n] = vals[start:stop]
        return p_hi, p_lo, p_vals

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
        obs = self.obs
        t0 = time.perf_counter() if obs is not None else 0.0
        try:
            # a capacity abort from the merge still records the span, with
            # its error attribute
            with (obs.tracer.span("engine/flush", rows=int(hi.shape[0]))
                  if obs is not None else contextlib.nullcontext()):
                for start in range(0, hi.shape[0], self.feed_batch):
                    stop = min(start + self.feed_batch, hi.shape[0])
                    self._merge_batch(self._pad(hi, lo, vals, start, stop))
                    self._merges += 1
                    if self._merges % self._check_every == 0:
                        self._health_sync()
        finally:
            if obs is not None:
                obs.registry.observe("engine/flush_ms",
                                     (time.perf_counter() - t0) * 1e3)
                obs.registry.count("engine/device_put_bytes",
                                   hi.nbytes + lo.nbytes + vals.nbytes)
                obs.registry.count("engine/flushes")

    def hint_total_keys(self, n: int) -> None:
        """The job-wide distinct-key count can never exceed ``n`` (e.g. the
        host dictionary's size): rules out over-growth and growth syncs."""
        self._total_hint = n

    def hint_live_upper_bound(self, ub: int) -> None:
        """Tighten the host-side live-key bound from external exact
        knowledge (e.g. the device mapper's dictionary size), avoiding
        growth syncs (JAX ``runtime/engine.py:251``)."""
        self._n_live_ub = min(self._n_live_ub, ub)

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
            # first (the only sync on the feed path), timed as a stall
            t0 = time.perf_counter()
            self._n_live_ub = self._read_live()
            if self.obs is not None:
                self.obs.registry.observe(
                    "engine/growth_sync_ms",
                    (time.perf_counter() - t0) * 1e3)
            needed = self._n_live_ub + incoming
            if self._total_hint is not None:
                needed = min(needed, self._total_hint)
        if needed <= self.capacity:
            return
        new_cap = min(self.max_capacity,
                      max(next_pow2(needed), next_pow2(self.capacity + 1)))
        # the grow's host side (its device work stays queued), as the span
        # engine/grow and the counter engine/grow_ms
        with (self.obs.step("engine/grow", old=self.capacity, new=new_cap)
              if self.obs is not None else contextlib.nullcontext()):
            self._apply_grow(new_cap)
        _log.info("accumulator grown %d -> %d rows", self.capacity, new_cap)
        if self.obs is not None:
            self.obs.registry.count("engine/grows")
            self.obs.registry.gauge("engine/capacity_rows", new_cap)
            self.obs.tracer.instant("engine/grow", old=self.capacity,
                                    new=new_cap)
        self.capacity = new_cap

    def _health_sync(self) -> None:
        """Periodic overflow check on the feed path, timed: the host blocks
        here for the device (``engine/health_sync_ms``)."""
        t0 = time.perf_counter()
        self._check_health()
        if self.obs is not None:
            self.obs.registry.observe("engine/health_sync_ms",
                                      (time.perf_counter() - t0) * 1e3)

    @abc.abstractmethod
    def _read_live(self) -> int:
        """Exact live-key count from the device (sync point)."""

    @abc.abstractmethod
    def _apply_grow(self, new_cap: int) -> None:
        """Extend the device accumulator with SENTINEL rows to ``new_cap``."""

    @abc.abstractmethod
    def _merge_batch(self, padded) -> None:
        """Fold one padded ``(hi, lo, vals)`` batch into device state."""

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
        #: full packed feed batches queued host-side and shipped as ONE
        #: stacked transfer; the merges still run one by one, in feed
        #: order.  Only an explicit ``dispatch_batch > 1`` batches here, as
        #: in the JAX package: auto (0) is the streamed k-means fit's
        self.dispatch_batch = max(1, config.dispatch_batch)
        self._queue: list = []
        self._keys, self._vals = make_accumulator(
            self.capacity, self.value_shape, self.value_dtype, self.combine,
            device=self.device)
        self._ovf = torch.zeros((), dtype=torch.int64, device=self.device)

    def _read_live(self) -> int:
        self._drain()
        return int(self._n_unique)

    def _apply_grow(self, new_cap: int) -> None:
        p_keys, p_vals = make_accumulator(
            new_cap - self.capacity, self.value_shape, self.value_dtype,
            self.combine, device=self.device)
        self._keys, self._vals = _grow_concat(self._keys, self._vals,
                                              p_keys, p_vals)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _round_batch(self, n: int) -> int:
        # batched dispatch stacks every packable slice at the ONE queue
        # shape (feed_batch), so a tail slice queues instead of draining a
        # partial queue (JAX ``runtime/engine.py:_round_batch``)
        if self.dispatch_batch > 1 and self._packable():
            return self.feed_batch
        return super()._round_batch(n)

    def _packable(self) -> bool:
        """Scalar int32 values ride the packed single-copy path; any other
        value type takes the plain merge."""
        return (self.value_shape == ()
                and self.value_dtype == np.dtype(np.int32))

    def _merge_batch(self, padded) -> None:
        hi, lo, vals = padded
        incoming = hi.shape[0]
        self._ensure_capacity(incoming)
        if not self._packable():
            self._drain()
            self._keys, self._vals, self._n_unique, self._ovf = merge(
                self._keys, self._vals, self._ovf,
                self._to_device(keys_from_planes(hi, lo)),
                self._to_device(vals), combine=self.combine)
            self._n_live_ub += incoming
            return
        packed = np.empty((3, incoming), np.int32)
        packed[0] = hi.view(np.int32)
        packed[1] = lo.view(np.int32)
        packed[2] = vals
        if self.dispatch_batch > 1 and incoming == self.feed_batch:
            self._queue.append(packed)
            self._n_live_ub += incoming
            if len(self._queue) >= self.dispatch_batch:
                self._drain()
            return
        self._drain()  # merge order = feed order
        self._keys, self._vals, self._n_unique, self._ovf = merge_packed(
            self._keys, self._vals, self._ovf, self._to_device(packed),
            combine=self.combine)
        self._n_live_ub += incoming

    def feed_device(self, hi: torch.Tensor, lo: torch.Tensor,
                    vals: torch.Tensor, count_rows: bool = True) -> None:
        """Merge a batch already on the device (JAX ``runtime/engine.py:
        512``): the device mapper's per-chunk unique rows, ``hi``/``lo`` as
        int32 u32 bit patterns (SENTINEL pairs are padding), no host
        staging, padding or copy."""
        self._drain()  # merge order = feed order
        incoming = hi.shape[0]
        self._ensure_capacity(incoming)
        if count_rows:
            self.rows_fed += incoming
        self._keys, self._vals, self._n_unique, self._ovf = merge(
            self._keys, self._vals, self._ovf,
            keys_from_plane_tensors(hi, lo), vals.to(self._vals.dtype),
            combine=self.combine)
        self._n_live_ub += incoming

    def _drain(self) -> None:
        """Ship the queued packed batches as one stacked copy and fold
        them in order.  A partial queue pads to B with dead batches
        (SENTINEL keys, identity values: a bit-exact no-op merge), so one
        ``(B, 3, feed_batch)`` shape serves every drain."""
        if not self._queue:
            return
        real = len(self._queue)
        if real < self.dispatch_batch:
            dead = np.empty((3, self.feed_batch), np.int32)
            dead[:2] = np.uint32(SENTINEL).view(np.int32)
            dead[2] = _identity(self.combine, np.int32)
            self._queue.extend([dead] * (self.dispatch_batch - real))
        stacked = np.stack(self._queue)
        self._queue = []
        self._keys, self._vals, self._n_unique, self._ovf = (
            merge_packed_batch(self._keys, self._vals, self._ovf,
                               self._to_device(stacked),
                               combine=self.combine, observed_chunks=real))

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
            packed = pack_finalize(
                self._keys, self._vals, self._n_unique, self._ovf)
            t0 = time.perf_counter()
            packed = packed.cpu().numpy().astype(np.uint32)
            observe_device_wait(t0)
            if packed[1, -1]:
                self._raise_dropped(int(packed[1, -1]))
            return (packed[0, :-1], packed[1, :-1],
                    packed[2, :-1].view(self.value_dtype), int(packed[0, -1]))
        t0 = time.perf_counter()
        dropped = int(self._ovf)
        hi, lo = planes_from_keys(self._keys)
        vals = self._vals.cpu().numpy()
        observe_device_wait(t0)
        if dropped:
            self._raise_dropped(dropped)
        return hi, lo, vals, int(self._n_unique)

    def _top_k_device(self, k: int):
        return top_k(self._keys, self._vals, min(k, self.capacity))
