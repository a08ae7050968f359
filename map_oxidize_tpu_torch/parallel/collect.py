"""Sharded collect: the variable-length-value reduce over the mesh.

The port of the JAX package's ``parallel/collect.py``
(``ShardedCollectEngine`` :78-505).  A **distributed sort-by-key**: every
flush routes its (key, doc) rows through the exchange of
:mod:`map_oxidize_tpu_torch.parallel.shuffle` (duplicates are data here,
so no pre-combine), each shard appends what it owns to a compacted
receive buffer, and finalize runs ONE (key, doc) sort per shard.  Routed
by key hash, key segments are disjoint across shards, so the per-shard
sorted runs concatenate into a valid global segment layout.  With
``splitters`` the partition is by RANGE (the total-order sort): shard s
owns ``[splitters[s-1], splitters[s])`` and the runs concatenate in the
global key order.

Each shard's receive buffer holds its rows as two int64 order-key columns
(key, doc; the doc compared unsigned, as the JAX package's ``lax.sort`` of
four u32 planes does).  An exchanged block is compacted (a STABLE key
sort moves the SENTINEL padding last, so a key's docs keep feed order)
and written at the shard's fill cursor, which stays on the device: only
live rows stay resident.  The host keeps an upper bound of the cursor and
reads the exact one only when the buffer looks full.

Past ``max_rows`` the transport decides (:mod:`map_oxidize_tpu_torch.
shuffle`): ``hybrid`` drains the shards into the host collect engine and
its disk-bucket spill takes over (a demotion), ``disk`` stages in the host
engine from row 0, ``hbm`` raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from map_oxidize_tpu_torch.api import MapOutput
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.segment_reduce import (
    SENTINEL_KEY,
    keys_from_planes,
)
from map_oxidize_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, make_mesh
from map_oxidize_tpu_torch.parallel.shuffle import (
    _exchange,
    exchange_payload_bytes,
    range_dest,
)
from map_oxidize_tpu_torch.runtime.engine import next_pow2
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: the flipped top bit of the order keys
_SIGN_I64 = -(1 << 63)


def raise_on_exchange_overflow(ovf) -> None:
    """Abort loudly if an exchange dropped rows."""
    dropped = int(ovf)
    if dropped:
        raise RuntimeError(
            f"{dropped} rows dropped in the collect exchange: a bucket "
            "overflowed bucket_cap; use the default safe cap or raise it")


def _live_pairs(keys: torch.Tensor, docs: torch.Tensor):
    """A shard's order-key columns -> host ``(u64 keys, i64 docs)`` of its
    live rows (JAX ``join_live_pairs``), or None when none is live."""
    live = keys != SENTINEL_KEY
    k = (keys[live] ^ _SIGN_I64).cpu().numpy()
    if not k.shape[0]:
        return None
    d = (docs[live] ^ _SIGN_I64).cpu().numpy()
    return k.view(np.uint64), d


def _lex_sort(keys: torch.Tensor, docs: torch.Tensor):
    """(key, doc) order of two order-key columns: a stable sort by doc,
    then a stable sort by key."""
    docs, o = torch.sort(docs, stable=True)
    keys = keys[o]
    keys, o = torch.sort(keys, stable=True)
    return keys, docs[o]


def _route_append(mesh: Mesh, buf_keys, buf_docs, cursor, keys, docs, *,
                  cap: int, splitters, method: str):
    """One flush (JAX ``collect/route_append``): exchange the shards'
    rows, compact each received block (stable key sort, SENTINEL last)
    and write it at the shard's cursor; returns the cursors advanced by
    the live rows and the global dropped-row count.  The buffers are
    written in place (the JAX program donates them)."""
    dests = None
    if splitters is not None:
        dests = mesh.run(lambda k, sp: range_dest(k, sp), keys, splitters)
    r_keys, r_docs, ovf = _exchange(mesh, keys, docs, cap, dests=dests,
                                    method=method)

    def append(bk, bd, cur, rk, rd):
        s_k, o = torch.sort(rk, stable=True)
        pos = cur + torch.arange(s_k.shape[0], device=s_k.device)
        bk.index_copy_(0, pos, s_k)
        bd.index_copy_(0, pos, rd[o])
        return cur + (s_k != SENTINEL_KEY).sum()

    cursor = mesh.run(append, buf_keys, buf_docs, cursor, r_keys, r_docs)
    return cursor, ovf[0]


def _grow(mesh: Mesh, buf_keys, buf_docs, pad: int):
    """Each shard's receive buffer grown by ``pad`` SENTINEL rows."""
    def one(b):
        return torch.cat([b, torch.full((pad,), SENTINEL_KEY,
                                        dtype=torch.int64, device=b.device)])

    return mesh.run(one, buf_keys), mesh.run(one, buf_docs)


def _sort_sharded(mesh: Mesh, buf_keys, buf_docs):
    """One (key, doc) sort per shard (JAX ``collect/sort_sharded``)."""
    out = mesh.run(_lex_sort, buf_keys, buf_docs)
    return [o[0] for o in out], [o[1] for o in out]


#: the sharded collect's programs under the launch ledger, by the JAX
#: package's names (``parallel/collect.py`` :184, :198, :209)
route_append = observed("collect/route_append", _route_append)
grow_buffers = observed("collect/grow", _grow)
sort_sharded = observed("collect/sort_sharded", _sort_sharded)


class ShardedCollectEngine:
    """Append-only sharded collection of (key, doc) pairs; one sort per
    shard at finalize.  The host surface is
    :class:`~map_oxidize_tpu_torch.runtime.collect.CollectEngine`'s
    (``feed`` / ``flush`` / ``finalize``), so the drivers are
    engine-agnostic."""

    #: the per-shard sorts run on the slots (a demoted engine's host
    #: drain is inside its finalize)
    sort_mode = "device"

    def __init__(self, config: JobConfig, mesh=None, bucket_cap: int = 0,
                 max_rows: int = 1 << 27, splitters=None,
                 pair_order: str = "stable", transport: str | None = None,
                 exchange_method: str = "all_to_all"):
        from map_oxidize_tpu_torch.shuffle import (
            make_transport,
            resolve_transport,
        )

        self.config = config
        #: wire program of the routing exchange (the chooser's knob)
        self.exchange_method = exchange_method
        self.mesh = mesh if mesh is not None else make_mesh(
            config.num_shards, config.backend)
        self.S = S = self.mesh.shape[SHARD_AXIS]
        self.device = self.mesh.devices[0]
        #: RANGE partition: S-1 ascending u64 splitters (None = hash)
        self.splitters = None
        self._sp = None
        if splitters is not None:
            splitters = np.asarray(splitters, np.uint64)
            if splitters.shape != (S - 1,):
                raise ValueError(
                    f"splitters must be (num_shards-1,) = ({S - 1},) "
                    f"ascending u64 keys, got shape {splitters.shape}")
            self.splitters = splitters
            sp = torch.from_numpy(
                (splitters ^ np.uint64(1 << 63)).view(np.int64).copy())
            self._sp = self.mesh.replicate(sp.to(self.device))
        #: host drain discipline handed to any host engine this one
        #: demotes to: "stable" (feed order) or "lex" (full (key, doc))
        self.pair_order = pair_order
        self.batch_per_shard = max(1, config.batch_size // S)
        self.feed_batch = self.batch_per_shard * S
        # fully safe default: one bucket can absorb a shard's whole block
        self.bucket_cap = (bucket_cap if bucket_cap > 0
                           else self.batch_per_shard)
        #: rows one exchange hands each shard ([S sources] x cap)
        self.block = S * self.bucket_cap
        self.max_rows = max_rows
        self.transport = (transport if transport is not None
                          else resolve_transport(config, max_rows))
        self._transport = make_transport(self.transport)
        self.rows_fed = 0
        self._obs = None
        self._stage: list = []
        self._staged = 0
        self._overflows: list = []
        self._buf: tuple | None = None   # (keys, docs) per-shard lists
        self._cursor = None              # per-shard 0-d int64 cursors
        self.R = 0                       # per-shard buffer rows
        self._cursor_ub = 0              # host upper bound of the cursor
        self._host = None
        if self.transport in ("disk", "remote"):
            self._activate_disk_transport()

    @property
    def obs(self):
        return self._obs

    @obs.setter
    def obs(self, value) -> None:
        # the bundle reaches whichever level stores the rows
        self._obs = value
        if self._host is not None:
            self._host.obs = value

    def _activate_disk_transport(self) -> None:
        """The disk transport: rows never stage on the device; the host
        pair engine buckets every feed from row 0."""
        from map_oxidize_tpu_torch.runtime.collect import CollectEngine

        host = CollectEngine(self.config, max_rows=self.max_rows,
                             sort_mode="host", transport="disk",
                             pair_order=self.pair_order)
        host.obs = self.obs
        self._host = host

    def _cursor_max(self) -> int:
        return int(torch.stack([c.to(self.device)
                                for c in self._cursor]).max())

    def _ensure_room(self) -> None:
        """Grow the receive buffers so one more exchanged block always
        fits below R; the exact cursor is read only when a growth looks
        necessary."""
        needed = self._cursor_ub + self.block
        if self._buf is None:
            self.R = max(next_pow2(needed), 1 << 12)
            self._buf = tuple(
                [torch.full((self.R,), SENTINEL_KEY, dtype=torch.int64,
                            device=d) for d in self.mesh.devices]
                for _ in range(2))
            self._cursor = [torch.zeros((), dtype=torch.int64, device=d)
                            for d in self.mesh.devices]
            return
        if needed <= self.R:
            return
        self._cursor_ub = self._cursor_max()
        needed = self._cursor_ub + self.block
        if needed <= self.R:
            return
        new_R = next_pow2(needed)
        self._buf = grow_buffers(self.mesh, *self._buf, new_R - self.R)
        self.R = new_R

    @property
    def spilled(self) -> bool:
        return self._host is not None and self._host.spilled

    @property
    def spilled_rows(self) -> int:
        return 0 if self._host is None else self._host.spilled_rows

    def feed(self, out: MapOutput) -> None:
        n = len(out)
        self.rows_fed += n
        if n == 0:
            return
        out.ensure_planes()
        vals = out.values
        if vals.ndim != 2 or vals.shape[1] != 2 or vals.dtype != np.uint32:
            raise ValueError("collect engines expect (n, 2) uint32 doc "
                             "planes")
        if self._host is not None:
            self._host.rows_fed = self.rows_fed - n  # its feed re-adds n
            self._host.feed(out)
            return
        if self._transport.admit(self.rows_fed, self.max_rows,
                                 "sharded pair collect "
                                 "(ShardedCollectEngine)") == "demote":
            self._demote_to_host()
            # the drained host engine was set to rows_fed, which already
            # counts this block's n; its feed re-adds n
            self._host.rows_fed = self.rows_fed - n
            self._host.feed(out)
            return
        self._stage.append((out.hi, out.lo, vals))
        self._staged += n
        if self._staged >= self.feed_batch:
            self.flush()

    def _demote_to_host(self) -> None:
        """Past max_rows: drain the per-shard buffers into the host collect
        engine, whose disk-bucket spill takes over.  A key's rows route to
        one shard, appended in feed order and compacted by a stable key
        sort, so the drained blocks keep the host engine's ascending-doc
        invariant."""
        from map_oxidize_tpu_torch.runtime.collect import CollectEngine
        from map_oxidize_tpu_torch.shuffle import record_demotion

        self.flush()
        self._check_exchange_overflows()
        _log.info(
            "sharded collect crossed max_rows=%d; demoting the %d-shard "
            "device buffers to the host engine (disk-bucket spill)",
            self.max_rows, self.S)
        host = CollectEngine(self.config, max_rows=self.max_rows,
                             sort_mode="host", pair_order=self.pair_order)
        host.obs = self.obs
        # the host engine is the demotion's target: its own spill begin is
        # part of this one transition
        host._transport.spilled_state = True
        with record_demotion(self.obs, self.rows_fed, "hbm", "disk",
                             shards=self.S, max_rows=self.max_rows):
            if self._buf is not None:
                for bk, bd in zip(*self._buf):
                    got = _live_pairs(bk, bd)
                    if got is None:
                        continue
                    host.feed(MapOutput(hi=None, lo=None, values=None,
                                        records_in=0, keys64=got[0],
                                        docs64=got[1]))
                self._buf = None
                self._cursor = None
        host.rows_fed = self.rows_fed
        self._host = host

    def _check_exchange_overflows(self) -> None:
        for ovf in self._overflows:
            raise_on_exchange_overflow(ovf)
        self._overflows = []

    def finalize_spilled_csr(self):
        if self._host is None:
            raise RuntimeError("engine did not demote/spill; use finalize")
        return self._host.finalize_spilled_csr()

    def finalize_spilled_runs(self):
        if self._host is None:
            raise RuntimeError("engine did not demote/spill; use finalize")
        return self._host.finalize_spilled_runs()

    def flush(self) -> None:
        if not self._staged:
            return
        hi = np.concatenate([s[0] for s in self._stage])
        lo = np.concatenate([s[1] for s in self._stage])
        vals = np.concatenate([s[2] for s in self._stage])
        self._stage = []
        self._staged = 0
        S = self.S
        mesh = self.mesh
        for start in range(0, hi.shape[0], self.feed_batch):
            stop = min(start + self.feed_batch, hi.shape[0])
            n = stop - start
            b = -(-min(next_pow2(max(n, 512)), self.feed_batch) // S) * S
            keys = np.full(b, np.iinfo(np.int64).max, np.int64)
            docs = np.full(b, np.iinfo(np.int64).max, np.int64)
            keys[:n] = keys_from_planes(hi[start:stop], lo[start:stop])
            docs[:n] = keys_from_planes(vals[start:stop, 0],
                                        vals[start:stop, 1])
            self._ensure_room()
            k_t = torch.from_numpy(np.stack([keys, docs]))
            if mesh.single_device:
                k_t = k_t.to(self.device)
            k_sh = mesh.split(k_t.T)
            t0 = time.perf_counter()
            self._cursor, ovf = route_append(
                mesh, *self._buf, self._cursor,
                [x[:, 0] for x in k_sh], [x[:, 1] for x in k_sh],
                cap=self.bucket_cap, splitters=self._sp,
                method=self.exchange_method)
            # worst case every live row landed on one shard
            self._cursor_ub += min(n, self.block)
            self._overflows.append(ovf)
            self._record_exchange(n, t0, ovf)

    def _record_exchange(self, n: int, t0: float, ovf,
                         program: str = "collect/route_append") -> None:
        """The shuffle counters and the comms row of one exchange: doc
        planes ride as an 8-byte value row, the latency is sampled on the
        ledger's cadence by waiting for the overflow count."""
        if self.obs is None:
            return
        from map_oxidize_tpu_torch.obs.metrics import sample_collective_wall

        reg = self.obs.registry
        payload = exchange_payload_bytes(self.S, self.bucket_cap, 8)
        reg.count("shuffle/exchanges")
        reg.count("shuffle/rows_exchanged", n)
        reg.count("shuffle/all_to_all_bytes", payload)
        reg.set("shuffle/exchange_collective", self.exchange_method)
        lat_ms = sample_collective_wall(self, "_n_appends", t0, ovf)
        reg.comm(self.exchange_method, program, payload,
                 shape=(self.S, self.bucket_cap), latency_ms=lat_ms)

    def finalize(self):
        """Route + sort everything fed; returns host ``(keys_u64,
        docs_i64)``: per-shard sorted runs, concatenated in shard order."""
        if self._host is not None:
            return self._host.finalize()
        self.flush()
        self._check_exchange_overflows()
        if self._buf is None:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        s_keys, s_docs = sort_sharded(self.mesh, *self._buf)
        keys_parts, docs_parts = [], []
        observed_rows = np.zeros(self.S, np.int64)
        for s in range(self.mesh.n_local):
            got = _live_pairs(s_keys[s], s_docs[s])
            if got is None:
                continue
            observed_rows[self.mesh.global_index(s)] = got[0].shape[0]
            keys_parts.append(got[0])
            docs_parts.append(got[1])
        dp = getattr(self.obs, "dataplane", None) if self.obs else None
        if dp is not None:
            # per-shard rows the exchange actually delivered
            dp.record_observed_rows(observed_rows)
        if not keys_parts:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        return np.concatenate(keys_parts), np.concatenate(docs_parts)


__all__ = ["ShardedCollectEngine", "raise_on_exchange_overflow"]
