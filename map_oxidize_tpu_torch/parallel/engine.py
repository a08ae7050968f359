"""Sharded streaming reduce engine: the mesh twin of
:class:`~map_oxidize_tpu_torch.runtime.engine.DeviceReduceEngine`.

The port of the JAX package's ``parallel/engine.py``
(``ShuffleOverflowError`` :36, ``ShardedReduceEngine`` :41, ``shuffle/
init_acc`` :83, ``feed_device`` :116, ``export_state`` / ``import_state``
:167 / :182).  One accumulator per shard, each owning a hash partition of
the key space; batches are routed to their owners by the exchange of
:mod:`map_oxidize_tpu_torch.parallel.shuffle` and folded locally.  The host
surface (``feed`` / ``finalize`` / ``top_k``) is the single-device one, so
the drivers are engine-agnostic.

A padded feed batch splits row-major over the shards (``Mesh.split``):
each shard "maps" (receives) B/S rows, then the exchange re-partitions
them by key.  The per-shard capacity is ``key_capacity // S`` and the
batch per shard ``batch_size // S``, as in the JAX package, so the memory
of S shards on one card is that of one engine plus the send buffers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from map_oxidize_tpu_torch.api import Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import observe_device_wait
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.ops.segment_reduce import (
    keys_from_plane_tensors,
    keys_from_planes,
    planes_from_keys,
    torch_dtype,
)
from map_oxidize_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from map_oxidize_tpu_torch.parallel.shuffle import (
    build_sharded_ops,
    exchange_payload_bytes,
    init_acc,
)
from map_oxidize_tpu_torch.runtime.engine import StreamingEngineBase


class ShuffleOverflowError(RuntimeError):
    """A hash bucket exceeded the exchange-buffer capacity, or a shard's
    accumulator its capacity: rows would have been dropped.  Increase
    ``bucket_cap`` / ``key_capacity`` (or shrink the batch)."""


class ShardedReduceEngine(StreamingEngineBase):
    """Folds MapOutputs into per-shard accumulators over a device mesh."""

    def __init__(self, config: JobConfig, reducer: Reducer,
                 value_shape: tuple = (), value_dtype=np.int32, mesh=None,
                 bucket_cap: int = 0, overflow_check_every: int = 16,
                 exchange_method: str = "all_to_all"):
        super().__init__(config, reducer, value_shape, value_dtype,
                         overflow_check_every)
        #: wire program of the exchange (the chooser's knob, resolved by
        #: the driver)
        self.exchange_method = exchange_method
        self.mesh = mesh if mesh is not None else make_mesh(
            config.num_shards, config.backend)
        self.S = self.mesh.shape[SHARD_AXIS]
        #: where the reduce runs: slot 0 (the port's ``accumulator_device``)
        self.device = self.mesh.devices[0]
        self.batch_per_shard = max(1, config.batch_size // self.S)
        self.max_capacity = max(1, config.key_capacity // self.S)
        self.capacity = min(
            max(1, -(-config.initial_key_capacity // self.S)),
            self.max_capacity)
        self.feed_batch = self.batch_per_shard * self.S
        self._merge, self._topk, self._grow, self.bucket_cap = (
            build_sharded_ops(self.mesh, self.combine, bucket_cap,
                              self.batch_per_shard,
                              exchange_method=exchange_method))
        self._keys, self._vals = init_acc(
            self.mesh, self.capacity, self.value_shape, self.value_dtype,
            self.combine)
        # the cumulative dropped-row counter, one per slot, all equal
        self._ovf = [torch.zeros((), dtype=torch.int64, device=d)
                     for d in self.mesh.devices]
        self._vbytes = int(self.value_dtype.itemsize * max(
            1, int(np.prod(self.value_shape, dtype=np.int64))))

    def _round_batch(self, n: int) -> int:
        b = super()._round_batch(n)
        return -(-b // self.S) * self.S  # S | batch rows

    def _incoming(self, batch_rows: int) -> int:
        # the most rows one merge can land on one shard: every source can
        # fill its bucket for it, never more than the batch
        return min(batch_rows, self.S * self.bucket_cap)

    def _read_live(self) -> int:
        return int(torch.stack([n.to(self.device)
                                for n in self._n_unique]).max())

    def _apply_grow(self, new_cap: int) -> None:
        self._keys, self._vals = self._grow(self._keys, self._vals,
                                            new_cap - self.capacity)

    def _merge_batch(self, padded) -> None:
        hi, lo, vals = padded
        mesh = self.mesh
        keys = torch.from_numpy(keys_from_planes(hi, lo))
        vals = torch.from_numpy(np.ascontiguousarray(vals))
        if mesh.single_device:
            # one copy to the slots' device, then views per shard
            keys, vals = keys.to(self.device), vals.to(self.device)
        self._feed(mesh.split(keys), mesh.split(vals), hi.shape[0])

    def feed_device(self, hi: list, lo: list, vals: list,
                    count_rows: bool = True) -> None:
        """Merge a batch already on the mesh: per-shard ``hi`` / ``lo``
        planes (int32 u32 bit patterns, SENTINEL pairs are padding) and
        values, each on its slot (JAX ``feed_device``: the sharded device
        map's tokenized rows flow straight into the exchange)."""
        self.mesh.check(hi, "key plane")
        rows = sum(int(h.shape[0]) for h in hi)
        if count_rows:
            self.rows_fed += rows
        keys = self.mesh.run(keys_from_plane_tensors, hi, lo)
        dt = torch_dtype(self.value_dtype)
        self._feed(keys, [v.to(dt) for v in vals], rows)

    def _feed(self, keys: list, vals: list, rows: int) -> None:
        incoming = self._incoming(rows)
        self._ensure_capacity(incoming)
        t0 = time.perf_counter()
        self._keys, self._vals, self._n_unique, self._ovf = self._merge(
            self._keys, self._vals, self._ovf, keys, vals)
        self._n_live_ub += incoming
        if self.obs is not None:
            from map_oxidize_tpu_torch.obs.metrics import (
                sample_collective_wall,
            )

            reg = self.obs.registry
            reg.count("shuffle/exchanges")
            reg.count("shuffle/rows_exchanged", rows)
            payload = exchange_payload_bytes(self.S, self.bucket_cap,
                                             self._vbytes)
            # the method-agnostic logical exchange (the merge report and
            # the gates read this name whichever wire program ran)
            reg.count("shuffle/all_to_all_bytes", payload)
            reg.set("shuffle/exchange_collective", self.exchange_method)
            # the per-merge psums: the [S] unique counts and the [S]
            # overflow counter, int32 each in the accounting identity
            psum_payload = 2 * 4 * self.S * self.S
            reg.count("shuffle/psum_bytes", psum_payload)
            lat_ms = sample_collective_wall(self, "_exchanges", t0,
                                            self._ovf)
            reg.comm(self.exchange_method, "shuffle/merge", payload,
                     shape=(self.S, self.bucket_cap), latency_ms=lat_ms)
            reg.comm("psum", "shuffle/merge", psum_payload,
                     shape=(self.S,))

    # --- snapshots: the JAX package's layout ----------------------------

    def export_state(self) -> dict:
        """Host snapshot of the sharded reduce state in the JAX engine's
        layout: global shard-major ``acc_hi`` / ``acc_lo`` / ``acc_vals``,
        ``ovf`` and ``n_unique`` ``[S]`` (-1 before any merge), and the
        host counters.  A JAX ``ShardedReduceEngine`` at the same S
        imports it, and this engine imports its."""
        keys = torch.cat([k.to(self.device) for k in self._keys])
        hi, lo = planes_from_keys(keys)
        n_unique = (np.full(self.S, -1, np.int32) if self._n_unique is None
                    else np.asarray([int(n) for n in self._n_unique],
                                    np.int32))
        return {
            "acc_hi": hi, "acc_lo": lo,
            "acc_vals": torch.cat([v.to(self.device)
                                   for v in self._vals]).cpu().numpy(),
            "ovf": np.asarray([int(o) for o in self._ovf], np.int32),
            "n_unique": n_unique,
            "n_live_ub": np.int64(self._n_live_ub),
            "rows_fed": np.int64(self.rows_fed),
        }

    def import_state(self, st: dict) -> None:
        """Restore an :meth:`export_state` snapshot (of either package)
        onto this engine's mesh, re-sharded."""
        mesh = self.mesh
        self.capacity = int(st["acc_hi"].shape[0]) // self.S
        keys = torch.from_numpy(keys_from_planes(st["acc_hi"],
                                                 st["acc_lo"]))
        vals = torch.from_numpy(np.array(st["acc_vals"]))
        self._keys = [k.to(d) for k, d in zip(keys.chunk(self.S),
                                               mesh.devices)]
        self._vals = [v.to(d, torch_dtype(self.value_dtype))
                      for v, d in zip(vals.chunk(self.S), mesh.devices)]
        ovf = np.asarray(st["ovf"]).reshape(-1)
        self._ovf = [torch.tensor(int(ovf[s % ovf.shape[0]]),
                                  dtype=torch.int64, device=d)
                     for s, d in enumerate(mesh.devices)]
        n = np.asarray(st["n_unique"], np.int64).reshape(-1)
        self._n_unique = (None if int(n[0]) < 0 else
                          [torch.tensor(int(n[s]), dtype=torch.int64,
                                        device=d)
                           for s, d in enumerate(mesh.devices)])
        self._n_live_ub = int(st["n_live_ub"])
        self.rows_fed = int(st["rows_fed"])

    # --- health and readback ---------------------------------------------

    def _check_health(self) -> None:
        dropped = int(self._ovf[0])  # host sync
        if dropped:
            raise ShuffleOverflowError(
                f"{dropped} rows dropped (bucket overflow or a shard "
                f"accumulator past key_capacity); increase bucket_cap / "
                "key_capacity")

    def _finalize(self):
        self._check_health()
        if self._n_unique is None:
            cap = self.capacity * self.S
            return (np.full(cap, SENTINEL, np.uint32),
                    np.full(cap, SENTINEL, np.uint32),
                    np.full((cap,) + self.value_shape, self._pad_val,
                            self.value_dtype), 0)
        t0 = time.perf_counter()
        keys = torch.cat([k.to(self.device) for k in self._keys])
        vals = torch.cat([v.to(self.device) for v in self._vals])
        n = int(torch.stack([n.to(self.device)
                             for n in self._n_unique]).sum())
        hi, lo = planes_from_keys(keys)
        vals = vals.cpu().numpy()
        observe_device_wait(t0)
        return hi, lo, vals, n

    def _top_k_device(self, k: int):
        out = self._topk(self._keys, self._vals, k)
        if self.obs is not None:
            # the two-level top-k gathers S*k_local candidate rows per
            # shard (key planes plus the value)
            k_local = min(k, self.capacity)
            self.obs.registry.comm(
                "all_gather", "shuffle/top_k",
                self.S * self.S * k_local * (8 + self._vbytes),
                shape=(self.S, k_local))
        return out
