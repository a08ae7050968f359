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

A later step (the multi-process drivers) puts a process group under these
same functions: each process then holds the list of its local shards.
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
    JAX mesh's is; ``devices[s]`` is slot ``s``'s device."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise RuntimeError("a mesh needs at least one device slot")
        self.size = len(self.devices)
        self.shape = {SHARD_AXIS: self.size}
        #: every slot on one device (the virtual pool on one card, or the
        #: CPU): collectives there move nothing between devices
        self.single_device = len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def run(self, fn, *per_shard_args) -> list:
        """``shard_map``'s counterpart: ``fn`` once per slot, in slot order,
        on that slot's entries of ``per_shard_args`` (each a list of S)."""
        for a in per_shard_args:
            if len(a) != self.size:
                raise ValueError(
                    f"per-shard argument has {len(a)} entries for "
                    f"{self.size} shards")
        return [fn(*(a[s] for a in per_shard_args))
                for s in range(self.size)]

    def check(self, xs, what: str = "tensor") -> None:
        """Raise unless ``xs[s]`` lies on slot ``s``'s device, for every
        slot: a sharded job never computes a shard elsewhere."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} per-shard {what}s for "
                             f"{self.size} shards")
        for s, (x, dev) in enumerate(zip(xs, self.devices)):
            if x.device != dev:
                raise RuntimeError(
                    f"shard {s}'s {what} is on {x.device}, not on its "
                    f"slot's device {dev}")

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Split ``x`` on dim 0 into S equal blocks (row-major, as a
        ``P('shards')`` sharding splits a global array) and place block
        ``s`` on slot ``s``: views where ``x`` already lies on a slot's
        device, copies elsewhere."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.size} shards")
        return [b if b.device == d else b.to(d)
                for b, d in zip(x.chunk(self.size), self.devices)]

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` on every slot: slots on ``x``'s device share it (it is
        read-only there), the others get a copy."""
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
    over it (a virtual pool), with a warning."""
    pool = real_pool(backend)
    if not pool:
        raise RuntimeError(
            f"backend {backend!r} requested but no CUDA device is "
            "available (pass backend='cpu' to run on the CPU)")
    n = num_shards if num_shards > 0 else len(pool)
    if n > len(pool):
        _log.warning(
            "%d shards exceed the %d-device %s pool; dealing %d virtual "
            "slots round-robin over it", n, len(pool), backend, n)
    return Mesh([pool[i % len(pool)] for i in range(n)])


# --- collectives --------------------------------------------------------------


def all_to_all(mesh: Mesh, bufs: list) -> list[torch.Tensor]:
    """``bufs[src]`` is shard ``src``'s ``[S, ...]`` send buffer, row
    ``dst`` addressed to shard ``dst``; returns ``out[dst]`` = ``[S, ...]``
    whose row ``src`` is ``bufs[src][dst]``, on ``dst``'s device
    (``lax.all_to_all(x, axis, 0, 0, tiled=True)``)."""
    mesh.check(bufs, "send buffer")
    S = mesh.size
    return [torch.stack([bufs[src][dst].to(mesh.devices[dst])
                         for src in range(S)])
            for dst in range(S)]


def all_gather(mesh: Mesh, xs: list, tiled: bool = False
               ) -> list[torch.Tensor]:
    """Every shard's ``xs[s]`` gathered on every slot, in shard order:
    stacked on a new leading axis, or concatenated on dim 0 with
    ``tiled`` (``lax.all_gather``).  Slots on one device share the
    gathered tensor."""
    mesh.check(xs)
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
    """The sum of every shard's ``xs[s]``, added in shard order 0..S-1 on
    slot 0's device (a fixed left fold, no atomics, so a float psum is
    bit-equal from run to run), then placed on every slot
    (:meth:`Mesh.replicate`)."""
    mesh.check(xs)
    d0 = mesh.devices[0]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(d0)
    if acc is xs[0]:
        acc = acc.clone()
    return mesh.replicate(acc)


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
           "all_to_all", "make_mesh", "psum", "real_pool", "shard_bounds"]
