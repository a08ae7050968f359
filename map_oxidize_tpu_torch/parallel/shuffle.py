"""Hash-bucket exchange and the sharded segment-reduce, in torch ops.

The port of the JAX package's ``parallel/shuffle.py`` (``bucket_of``
:147, ``range_dest`` :156, ``_exchange`` :172, ``_merge_step`` :259,
``_topk_step`` :294, ``build_sharded_ops`` :325).  Owner-computes over a
hash partition of the key space:

    per shard: bucket rows by ``(hi ^ lo) % S``  ->  stable sort by
    bucket  ->  scatter into a fixed [S, cap] send buffer  ->  exchange
    (:func:`~map_oxidize_tpu_torch.parallel.mesh.all_to_all`, or the
    ``all_gather`` + slice decomposition)  ->  every row sits on its
    owner shard  ->  sort + segment-combine into that shard's accumulator.

Ragged buckets are padded to capacity: padding rows carry the SENTINEL
key, real rows past ``cap`` are dropped and COUNTED (psum over shards),
and the engine raises on a nonzero count.  Global top-k is two-level:
per-shard top-k, an ``all_gather`` of the S*k candidates, a final select.

Keys are the port's int64 order keys (the top bit flipped, see
:mod:`map_oxidize_tpu_torch.ops.segment_reduce`); routing reads the
UNFLIPPED u64 bits as the JAX package's u32 planes, so a key lands on the
same shard in both packages, and on the data-plane audit's partition
(``obs/dataplane.py`` ``partition_of``).  Routing, ranking and scatter
are sync-free on the card: counts go through ``index_add_`` on integers,
and rows past ``cap`` scatter into a dump slot that is cut off.
"""

from __future__ import annotations

from functools import partial

import torch

from map_oxidize_tpu_torch.obs.calib import EXCHANGE_COLLECTIVE_NAMES
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.segment_reduce import (
    SENTINEL_KEY,
    make_accumulator,
    reduce_pairs,
)
from map_oxidize_tpu_torch.ops.topk import mask_padding
from map_oxidize_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    all_gather,
    all_to_all,
    psum,
)
from map_oxidize_tpu_torch.runtime.planner import (  # noqa: F401 (re-export)
    choose_collective,
    exchange_payload_bytes,
)

#: the exchange wire programs (JAX ``EXCHANGE_COLLECTIVES``): the
#: monolithic ``all_to_all``, and ``all_gather`` of every shard's send
#: buffer followed by the slice addressed to this shard; the same routed
#: rows bit for bit
EXCHANGE_COLLECTIVES = EXCHANGE_COLLECTIVE_NAMES

#: the flipped top bit of the order keys
_SIGN_I64 = -(1 << 63)


def key_planes(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 order keys -> the unsigned (hi, lo) u32 planes of their u64
    bits, as int64 tensors."""
    u = keys ^ _SIGN_I64
    return (u >> 32) & 0xFFFFFFFF, u & 0xFFFFFFFF


def bucket_of(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owner shard of each key: ``(hi ^ lo) % S`` on its u32 planes (JAX
    ``bucket_of``), int64."""
    hi, lo = key_planes(keys)
    return (hi ^ lo) % num_shards


def range_dest(keys: torch.Tensor, sp_keys: torch.Tensor) -> torch.Tensor:
    """Owner shard of each key under a RANGE partition (the total-order
    sort): the count of splitters ``<=`` the key, i.e. ``searchsorted(
    splitters, key, side='right')`` (JAX ``range_dest``).  ``sp_keys``
    holds the S-1 ascending splitters as order keys, whose signed order
    is the unsigned order of the u64 keys."""
    return torch.searchsorted(sp_keys, keys, right=True)


def _route(keys, vals, dest, *, S: int, cap: int):
    """One shard's send side: its rows scattered into the ``[S, cap]``
    send buffer (key SENTINEL and value 0 in empty slots), and the count
    of REAL rows past ``cap`` (JAX ``_exchange`` :191-225).  Padding rows
    are dealt round-robin by index (``arange(B) % S``) so they never
    crowd one bucket; a stable sort by destination keeps real rows, which
    the caller compacts ahead of the padding, at the lowest ranks."""
    dev = keys.device
    B = keys.shape[0]
    is_pad = keys == SENTINEL_KEY
    idx = torch.arange(B, device=dev)
    if dest is None:
        dest = bucket_of(keys, S)
    dest = torch.where(is_pad, idx % S, dest)
    dest_s, perm = torch.sort(dest, stable=True)
    starts = torch.searchsorted(dest_s, torch.arange(S, device=dev))
    rank = idx - starts[dest_s]
    real = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(
        0, dest, (~is_pad).long())
    overflow = (real - cap).clamp_min(0).sum()
    # rows at rank >= cap go to the dump slot S*cap, which is cut off
    slot = torch.where(rank < cap, dest_s * cap + rank, S * cap)
    buf_keys = torch.full((S * cap + 1,), SENTINEL_KEY, dtype=torch.int64,
                          device=dev)
    buf_keys[slot] = keys[perm]
    buf_vals = torch.zeros((S * cap + 1,) + tuple(vals.shape[1:]),
                           dtype=vals.dtype, device=dev)
    buf_vals[slot] = vals[perm]
    tail = tuple(vals.shape[1:])
    return (buf_keys[:-1].view(S, cap), buf_vals[:-1].view((S, cap) + tail),
            overflow)


def _exchange(mesh: Mesh, keys: list, vals: list, cap: int, dests=None,
              method: str = "all_to_all"):
    """Route every shard's rows to their owner shard (JAX ``_exchange``).
    ``dests`` overrides the hash buckets per shard (the sort's range
    partition).  Returns per local shard the ``[S*cap]`` rows it owns
    after the exchange (source-major) and the global count of dropped
    real rows (the same on every slot)."""
    if method not in EXCHANGE_COLLECTIVES:
        raise ValueError(f"exchange method must be one of "
                         f"{EXCHANGE_COLLECTIVES}, got {method!r}")
    S = mesh.size
    if dests is None:
        dests = [None] * mesh.n_local
    sent = mesh.run(partial(_route, S=S, cap=cap), keys, vals, dests)
    buf_keys = [x[0] for x in sent]
    buf_vals = [x[1] for x in sent]
    if method == "all_gather":
        # gather every shard's [S, cap] send buffer ([S_src, S, cap]) and
        # take column `my`: the block every shard addressed to this one,
        # exactly the rows all_to_all delivers
        g_keys = all_gather(mesh, buf_keys)
        g_vals = all_gather(mesh, buf_vals)
        r_keys = [g_keys[i][:, mesh.global_index(i)]
                  for i in range(mesh.n_local)]
        r_vals = [g_vals[i][:, mesh.global_index(i)]
                  for i in range(mesh.n_local)]
    else:
        r_keys = all_to_all(mesh, buf_keys)
        r_vals = all_to_all(mesh, buf_vals)
    total = psum(mesh, [x[2] for x in sent])
    tail = tuple(vals[0].shape[1:])
    return ([k.reshape(S * cap) for k in r_keys],
            [v.reshape((S * cap,) + tail) for v in r_vals], total)


def _merge_step(mesh: Mesh, acc_keys, acc_vals, ovf, b_keys, b_vals, *,
                cap: int, combine: str, method: str = "all_to_all"):
    """One streaming fold over the mesh (JAX ``_merge_step``): each shard
    pre-combines its batch (so a hot key's duplicates do not crowd one
    bucket), the exchange routes the rows, and each shard sort +
    segment-combines them into its ``C``-row accumulator.  ``ovf`` is the
    cumulative dropped-row counter, per slot and equal on every slot: the
    exchange's drops plus the psum of each shard's truncation
    ``max(n_unique - C, 0)``.  Returns ``(keys, vals, n_unique, ovf)``,
    each a per-shard list (``n_unique`` the per-shard unique counts)."""
    C = acc_keys[0].shape[0]
    pre = mesh.run(partial(reduce_pairs, combine=combine), b_keys, b_vals)
    r_keys, r_vals, overflow = _exchange(
        mesh, [p[0] for p in pre], [p[1] for p in pre], cap, method=method)
    merged = mesh.run(
        lambda ak, av, rk, rv: reduce_pairs(torch.cat([ak, rk]),
                                            torch.cat([av, rv]), combine),
        acc_keys, acc_vals, r_keys, r_vals)
    n_unique = [m[2] for m in merged]
    drop = psum(mesh, [(n - C).clamp_min(0) for n in n_unique])
    ovf = mesh.run(lambda o, x, d: o + x + d, ovf, overflow, drop)
    return ([m[0][:C] for m in merged], [m[1][:C] for m in merged],
            n_unique, ovf)


def _local_top_k(keys, vals, k: int):
    """A shard's top ``k`` rows by value, ties to the lower index (a
    stable descending sort, as ``lax.top_k`` selects); padding sinks to
    the dtype floor."""
    top_v, idx = torch.sort(mask_padding(keys, vals), descending=True,
                            stable=True)
    return keys[idx[:k]], top_v[:k]


def _topk_step(mesh: Mesh, acc_keys, acc_vals, *, k_local: int,
               k_final: int):
    """Two-level top-k (JAX ``_topk_step``): each shard's ``k_local``
    candidates, an ``all_gather`` of the ``S * k_local``, and the final
    select by value descending with LIVE rows first among equal values
    and, among those, the HIGHER gathered index first (``lexsort((live,
    value))``, the last ``k_final`` reversed).  The result is the same on
    every slot; slot 0's is returned as ``(keys, vals)``."""
    loc = mesh.run(partial(_local_top_k, k=k_local), acc_keys, acc_vals)
    gk = all_gather(mesh, [x[0] for x in loc], tiled=True)[0]
    gv = all_gather(mesh, [x[1] for x in loc], tiled=True)[0]
    live = (gk != SENTINEL_KEY).to(torch.int8)
    # lexsort((live, gv)): a stable sort by the minor key, then by the
    # major one
    o1 = torch.sort(live, stable=True)[1]
    order = o1[torch.sort(gv[o1], stable=True)[1]]
    sel = order[order.shape[0] - k_final:].flip(0)
    return gk[sel], gv[sel]


def _grow(mesh: Mesh, acc_keys, acc_vals, pad: int, combine: str):
    """Grow each shard's accumulator by ``pad`` SENTINEL rows (per shard:
    a global concatenation would pad only after shard S-1)."""
    def one(k, v):
        p_k, p_v = make_accumulator(pad, tuple(v.shape[1:]), v.dtype,
                                    combine, device=k.device)
        return torch.cat([k, p_k]), torch.cat([v, p_v])

    out = mesh.run(one, acc_keys, acc_vals)
    return [o[0] for o in out], [o[1] for o in out]


def _init_acc(mesh: Mesh, capacity: int, value_shape: tuple, value_dtype,
              combine: str):
    """Fresh per-shard accumulators, each made on its own slot."""
    out = [make_accumulator(capacity, value_shape, value_dtype, combine,
                            device=d) for d in mesh.devices]
    return [o[0] for o in out], [o[1] for o in out]


#: the sharded programs under the launch ledger, by the JAX package's
#: program names (``parallel/shuffle.py`` :364, :380, :407,
#: ``parallel/engine.py:83``)
merge_step = observed("shuffle/merge", _merge_step)
topk_step = observed("shuffle/top_k", _topk_step)
grow_step = observed("shuffle/grow", _grow)
init_acc = observed("shuffle/init_acc", _init_acc)


def default_bucket_cap(batch_per_shard: int, num_shards: int) -> int:
    """Slots per destination in the send buffer (JAX
    ``build_sharded_ops`` :346-349): the expected load B/S doubled for
    hash variance, plus slack for the round-robin padding rows, never
    above the batch."""
    return min(batch_per_shard, 2 * (-(-batch_per_shard // num_shards)) + 16)


def build_sharded_ops(mesh: Mesh, combine: str = "sum", bucket_cap: int = 0,
                      batch_per_shard: int = 0,
                      exchange_method: str = "all_to_all"):
    """The sharded merge step, top-k and grow for ``mesh`` (JAX
    ``build_sharded_ops``).  Returns ``(merge_fn, topk_fn, grow_fn,
    bucket_cap)``:

    * ``merge_fn(acc_keys, acc_vals, ovf, b_keys, b_vals)`` — per-shard
      lists; returns the updated accumulators, the per-shard unique
      counts and the cumulative overflow counters (nonzero = rows were
      dropped; the caller raises);
    * ``topk_fn(acc_keys, acc_vals, k)`` — ``(keys, vals)``;
    * ``grow_fn(acc_keys, acc_vals, pad_per_shard)``.

    ``bucket_cap`` 0 derives :func:`default_bucket_cap`."""
    S = mesh.shape[SHARD_AXIS]
    if bucket_cap <= 0:
        if batch_per_shard <= 0:
            raise ValueError("need bucket_cap or batch_per_shard")
        bucket_cap = default_bucket_cap(batch_per_shard, S)

    def merge_fn(acc_keys, acc_vals, ovf, b_keys, b_vals):
        # the exchange method is part of the program's signature: a
        # chooser flip is a new program to the launch ledger
        return merge_step(mesh, acc_keys, acc_vals, ovf, b_keys, b_vals,
                          cap=bucket_cap, combine=combine,
                          method=exchange_method)

    def topk_fn(acc_keys, acc_vals, k: int):
        k_local = min(k, acc_keys[0].shape[0])
        k_final = min(k, S * k_local)
        return topk_step(mesh, acc_keys, acc_vals, k_local=k_local,
                         k_final=k_final)

    def grow_fn(acc_keys, acc_vals, pad_per_shard: int):
        return grow_step(mesh, acc_keys, acc_vals, pad_per_shard, combine)

    return merge_fn, topk_fn, grow_fn, bucket_cap
