"""The device mesh of the sharded engines, and its collectives.

The port of the JAX package's ``parallel/mesh.py`` (``make_mesh`` :29) and
of the two functions of its ``utils/jax_compat.py`` (``shard_map`` :15,
``device_put_handoff`` :31).  There, a mesh is a ``jax.sharding.Mesh``
of S devices in ONE process, per-shard bodies run under ``shard_map``,
and the collectives (``psum``, ``all_to_all``, ``all_gather``) are XLA's.
Here a mesh is the same thing in PyTorch terms:

* an ordered tuple of S ``torch.device`` slots (:class:`Mesh`), one
  axis, :data:`SHARD_AXIS`;
* per-shard tensors held as a list, entry ``s`` on slot ``s``'s device;
* :meth:`Mesh.run` in place of ``shard_map``: a loop over the slots;
* the collectives over those lists (:func:`all_to_all`,
  :func:`all_gather`, :func:`psum`), in a fixed order, with no atomics.

**The pool.**  The real pool is ``torch.cuda.device_count()`` cards for
``cuda`` and the one CPU device for ``cpu``.  ``num_shards=0`` is the real
pool.  An explicit ``num_shards`` larger than the real pool deals S slots
round-robin over it (a *virtual* pool, logged), as the JAX package falls
back to a virtual CPU pool: on a host with one H100 it puts 8 shards on
``cuda:0``, and on the CPU it gives the tests their 8 shards.

**One stream.**  Slots on one card enqueue on its current stream, which
runs in order, so a collective among them is a set of on-device copies
and needs no synchronisation.  A copy between two cards is ordered by
PyTorch after the source's current stream and before the destination's.

**Several processes.**  Under a ``torch.distributed`` process group
(:func:`~map_oxidize_tpu_torch.parallel.distributed.init_distributed`) a
mesh has S GLOBAL slots, of which process ``p`` of ``P`` owns the S/P
LOCAL slots ``p*S/P .. (p+1)*S/P - 1`` (process-major, as ``jax.devices()``
orders a multi-process mesh).  ``Mesh.devices`` and every per-shard list
are the local slots; ``Mesh.size`` stays S, the axis the keys route over.
The collectives keep their signatures: rows for a slot of the same process
move on its device, and only rows that cross processes are staged through
host buffers (pinned on a card) and one Gloo call (:func:`all_to_all`,
:func:`all_gather`).  A float :func:`psum` gathers every shard's partial
and adds them in global shard order 0..S-1, never through Gloo's ring
``all_reduce``, so a P-process sum is bit-equal to the one-process S-slot
sum.  Unsigned and bool tensors cross as their bytes.  With one process
every collective is the in-process one above.
"""

from __future__ import annotations

import torch

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

SHARD_AXIS = "shards"


def real_pool(backend: str) -> list[torch.device]:
    """The devices a backend really has: every CUDA card (none when CUDA
    is absent), or the one CPU device.  Reading the card count does not
    initialise CUDA."""
    if backend == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if backend == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"backend must be cuda|cpu, got {backend!r}")


class Mesh:
    """S device slots on one axis.  ``shape`` is ``{SHARD_AXIS: S}``, as a
    JAX mesh's is.  ``devices[i]`` is LOCAL slot ``i``'s device, global
    slot ``offset + i``; with one process the local slots are all S."""

    def __init__(self, devices, process: int = 0, n_processes: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise RuntimeError("a mesh needs at least one device slot")
        #: this process's slot among ``n_processes`` (0 / 1 in one process)
        self.process = int(process)
        self.n_processes = int(n_processes)
        #: local slots of this process, and the global index of the first
        self.n_local = len(self.devices)
        self.offset = self.process * self.n_local
        self.size = self.n_local * self.n_processes
        self.shape = {SHARD_AXIS: self.size}
        #: more than one process: the collectives cross the process group
        self.distributed = self.n_processes > 1
        #: every local slot on one device (the virtual pool on one card, or
        #: the CPU): collectives among them move nothing between devices
        self.single_device = len(set(self.devices)) == 1

    def __repr__(self) -> str:
        where = (f", process {self.process}/{self.n_processes}"
                 if self.distributed else "")
        return f"Mesh({[str(d) for d in self.devices]}{where})"

    def global_index(self, i: int) -> int:
        """Global slot of local slot ``i``."""
        return self.offset + i

    def run(self, fn, *per_shard_args) -> list:
        """``shard_map``'s counterpart: ``fn`` once per local slot, in slot
        order, on that slot's entries of ``per_shard_args`` (each a list
        with one entry per local slot)."""
        for a in per_shard_args:
            if len(a) != self.n_local:
                raise ValueError(
                    f"per-shard argument has {len(a)} entries for "
                    f"{self.n_local} shards")
        return [fn(*(a[s] for a in per_shard_args))
                for s in range(self.n_local)]

    def check(self, xs, what: str = "tensor") -> None:
        """Raise unless ``xs[i]`` lies on local slot ``i``'s device, for
        every local slot: a sharded job never computes a shard
        elsewhere."""
        if len(xs) != self.n_local:
            raise ValueError(f"{len(xs)} per-shard {what}s for "
                             f"{self.n_local} shards")
        for s, (x, dev) in enumerate(zip(xs, self.devices)):
            if x.device != dev:
                raise RuntimeError(
                    f"shard {self.global_index(s)}'s {what} is on "
                    f"{x.device}, not on its slot's device {dev}")

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Split ``x`` (this process's rows) on dim 0 into one equal block
        per local slot (row-major, as a ``P('shards')`` sharding splits a
        global array, whose process-local rows ``make_array_from_process_
        local_data`` deals to the local devices in order) and place block
        ``i`` on local slot ``i``: views where ``x`` already lies on a
        slot's device, copies elsewhere."""
        if x.shape[0] % self.n_local:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.n_local} shards")
        return [b if b.device == d else b.to(d)
                for b, d in zip(x.chunk(self.n_local), self.devices)]

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` on every local slot: slots on ``x``'s device share it (it
        is read-only there), the others get a copy."""
        copies: dict = {x.device: x}
        out = []
        for d in self.devices:
            if d not in copies:
                copies[d] = x.to(d)
            out.append(copies[d])
        return out


def make_mesh(num_shards: int = 0, backend: str = "cuda") -> Mesh:
    """A mesh of ``num_shards`` slots over ``backend``'s real pool (0 =
    the whole pool).  More slots than the pool has are dealt round-robin
    over it (a virtual pool), with a warning.

    Under an initialised process group of P processes, ``num_shards`` is
    the GLOBAL slot count (0 = P times the local pool) and must divide by
    P; this process's S/P local slots are dealt over its own pool."""
    pool = real_pool(backend)
    if not pool:
        raise RuntimeError(
            f"backend {backend!r} requested but no CUDA device is "
            "available (pass backend='cpu' to run on the CPU)")
    process, n_proc = process_slot()
    n = num_shards if num_shards > 0 else len(pool) * n_proc
    if n % n_proc:
        raise ValueError(
            f"shard count {n} must divide by process count {n_proc} "
            "(every process owns an equal mesh slice)")
    n_local = n // n_proc
    if n_local > len(pool):
        _log.warning(
            "%d shards exceed the %d-device %s pool; dealing %d virtual "
            "slots round-robin over it", n_local, len(pool), backend,
            n_local)
    return Mesh([pool[i % len(pool)] for i in range(n_local)],
                process=process, n_processes=n_proc)


def process_slot() -> tuple[int, int]:
    """``(rank, world size)`` of the initialised default process group, or
    ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# --- collectives --------------------------------------------------------------

#: what this process has sent to other processes over Gloo, all jobs of the
#: process together: ``{"bytes": ..., "calls": ...}`` (read by the drivers'
#: logs and ``chip_smoke.py``; no metric key names the wire)
WIRE = {"bytes": 0, "calls": 0}


def _sent(nbytes: int) -> None:
    WIRE["bytes"] += int(nbytes)
    WIRE["calls"] += 1


def _wire_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the flat uint8 bytes Gloo carries, on the host: pinned
    when it comes from a card (unsigned, bool and bf16 tensors cross as
    their bytes)."""
    x = x.contiguous()
    if x.device.type == "cpu":
        return x.reshape(-1).view(torch.uint8)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host.reshape(-1).view(torch.uint8)


def _from_wire(b: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    """The inverse of :func:`_wire_bytes` for one received block."""
    x = b.view(dtype).reshape(shape)
    return x if device.type == "cpu" else x.to(device, non_blocking=True)


def _gather_local(mesh: Mesh, stacked: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``[n_local, ...]`` block (the same shape on all),
    in process order, on this process's slot-0 device: the own block
    stays where it is, the others come through one Gloo ``all_gather``."""
    import torch.distributed as dist

    wire = _wire_bytes(stacked)
    got = [torch.empty_like(wire) for _ in range(mesh.n_processes)]
    dist.all_gather(got, wire)
    _sent(wire.numel() * (mesh.n_processes - 1))
    d0 = mesh.devices[0]
    return [stacked.to(d0) if q == mesh.process
            else _from_wire(got[q], stacked.shape, stacked.dtype, d0)
            for q in range(mesh.n_processes)]


def all_to_all(mesh: Mesh, bufs: list) -> list[torch.Tensor]:
    """``bufs[i]`` is local shard ``i``'s ``[S, ...]`` send buffer, row
    ``dst`` addressed to global shard ``dst``; returns ``out[j]`` =
    ``[S, ...]`` whose row ``src`` is global shard ``src``'s row for local
    shard ``j``, on ``j``'s device (``lax.all_to_all(x, axis, 0, 0,
    tiled=True)``).  Across processes, the rows addressed to another
    process's slots cross in one Gloo ``all_to_all``; the receiver lays
    them out in global source order."""
    mesh.check(bufs, "send buffer")
    if not mesh.distributed:
        S = mesh.size
        return [torch.stack([bufs[src][dst].to(mesh.devices[dst])
                             for src in range(S)])
                for dst in range(S)]
    import torch.distributed as dist

    L, P, me = mesh.n_local, mesh.n_processes, mesh.process
    d0 = mesh.devices[0]
    # send[q] = [L_src, L_dst(q), ...]: this process's rows for q's slots
    send = [torch.stack([b[q * L:(q + 1) * L].to(d0) for b in bufs])
            for q in range(P)]
    block = send[0]
    nbytes = block.numel() * block.element_size()
    wire_in = torch.cat([_wire_bytes(send[q]) if q != me
                         else torch.empty(0, dtype=torch.uint8)
                         for q in range(P)])
    splits = [0 if q == me else nbytes for q in range(P)]
    wire_out = torch.empty(nbytes * (P - 1), dtype=torch.uint8)
    dist.all_to_all_single(wire_out, wire_in, output_split_sizes=splits,
                           input_split_sizes=splits)
    _sent(wire_in.numel())
    recv, off = [], 0
    for q in range(P):
        if q == me:
            recv.append(send[q])
            continue
        recv.append(_from_wire(wire_out[off:off + nbytes], block.shape,
                               block.dtype, d0))
        off += nbytes
    # recv[q][i, j] = global source q*L+i's rows for local slot j
    full = torch.cat(recv)          # [S, L, ...] in global source order
    return [full[:, j].to(mesh.devices[j]) for j in range(L)]


def all_gather(mesh: Mesh, xs: list, tiled: bool = False
               ) -> list[torch.Tensor]:
    """Every shard's ``xs[s]`` gathered on every local slot, in global
    shard order: stacked on a new leading axis, or concatenated on dim 0
    with ``tiled`` (``lax.all_gather``).  Slots on one device share the
    gathered tensor.  Across processes every shard's block must have the
    same shape (SPMD, as under ``shard_map``)."""
    mesh.check(xs)
    if mesh.distributed:
        d0 = mesh.devices[0]
        blocks = _gather_local(mesh, torch.stack([x.to(d0) for x in xs]))
        g = torch.cat(blocks)
        if tiled:
            g = g.reshape((-1,) + tuple(g.shape[2:]))
        return mesh.replicate(g)
    by_device: dict = {}
    out = []
    for d in mesh.devices:
        g = by_device.get(d)
        if g is None:
            parts = [x.to(d) for x in xs]
            g = by_device[d] = (torch.cat(parts) if tiled
                                else torch.stack(parts))
        out.append(g)
    return out


def psum(mesh: Mesh, xs: list) -> list[torch.Tensor]:
    """The sum of every shard's ``xs[s]``, added in global shard order
    0..S-1 on local slot 0's device (a fixed left fold, no atomics, so a
    float psum is bit-equal from run to run and from one process to P),
    then placed on every local slot (:meth:`Mesh.replicate`).  Across
    processes the partials are gathered first (:func:`all_gather`)."""
    mesh.check(xs)
    d0 = mesh.devices[0]
    parts = all_gather(mesh, xs)[0] if mesh.distributed else xs
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x.to(d0)
    if acc is xs[0]:
        acc = acc.clone()
    return mesh.replicate(acc)


def process_allgather(mesh: Mesh, a) -> "np.ndarray":
    """``jax.experimental.multihost_utils.process_allgather`` of a host
    array: ``(P, *a.shape)``, one row per process in process order; every
    process must pass the same shape.  One process gets ``a[None]``."""
    import numpy as np

    a = np.ascontiguousarray(a)
    if not mesh.distributed:
        return a[None].copy()
    import torch.distributed as dist

    wire = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    got = [torch.empty_like(wire) for _ in range(mesh.n_processes)]
    dist.all_gather(got, wire)
    _sent(wire.numel() * (mesh.n_processes - 1))
    return np.stack([g.numpy().view(a.dtype).reshape(a.shape)
                     for g in got])


def barrier(mesh: Mesh) -> None:
    """Every process of the mesh reaches this point (``dist.barrier``);
    nothing with one process."""
    if mesh.distributed:
        import torch.distributed as dist

        dist.barrier()


# --- staging (``device_put_handoff``) ---------------------------------------


class ShardedStagingRing:
    """The per-shard put of staged blocks: one
    :class:`~map_oxidize_tpu_torch.runtime.pipeline.StagingRing` per slot
    (pinned host buffers copied with ``non_blocking=True`` on a copy
    stream, a slot not refilled until the launches that read it have
    finished).  This is the contract the JAX package's
    ``device_put_handoff`` keeps by giving each staged block a fresh
    buffer; a fixed ring keeps it with events and bounded memory."""

    def __init__(self, mesh: Mesh, slots: int, rows_per_shard: int, d: int,
                 dtype: torch.dtype):
        from map_oxidize_tpu_torch.runtime.pipeline import StagingRing

        self.mesh = mesh
        self.rings = [StagingRing(slots, rows_per_shard, d, dtype, dev)
                      for dev in mesh.devices]

    def stage(self, seq: int, parts_per_shard: list) -> int:
        """Fill ring slot ``seq % slots`` of every shard with that shard's
        row parts (a list of host arrays, concatenated in order) and start
        their copies.  Returns the ring slot."""
        slot = None
        for ring, parts in zip(self.rings, parts_per_shard):
            slot = ring.stage_parts(seq, parts)
        return slot

    def acquire(self, slot: int) -> list[torch.Tensor]:
        return [ring.acquire(slot) for ring in self.rings]

    def release(self, slot: int, seq: int) -> None:
        for ring in self.rings:
            ring.release(slot, seq)


def shard_bounds(n: int, num_shards: int) -> list[tuple[int, int]]:
    """Row ranges of an ``n``-row array padded to a multiple of S and split
    evenly (the JAX package's ``P('shards')`` split of a zero-weight
    padded array): ``[(lo, hi), ...]`` clipped to the real rows, so a
    trailing shard may hold fewer rows, or none."""
    per = -(-n // num_shards) if n else 0
    return [(min(s * per, n), min((s + 1) * per, n))
            for s in range(num_shards)]


__all__ = ["SHARD_AXIS", "Mesh", "ShardedStagingRing", "all_gather",
           "all_to_all", "barrier", "make_mesh", "process_allgather",
           "process_slot", "psum", "real_pool", "shard_bounds"]
