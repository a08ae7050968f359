"""Sort + segment-combine: the device-side reduce, in torch ops.

The port of the JAX package's ``ops/segment_reduce.py``, whose functions are
XLA programs (not Pallas kernels), so torch ops are their form here:

    sort rows by 64-bit key  ->  detect key-change boundaries  ->
    segment-combine values   ->  compact unique keys to the front

Padding rows carry the SENTINEL key, sort to the end, and are masked out of
the unique count.  The streaming fold (:func:`merge_into_accumulator`)
concatenates a device-resident accumulator of reduced pairs with each
incoming batch and re-reduces, keeping the first ``capacity`` rows.

**Key representation.**  The JAX package carries a key as two uint32 planes
and sorts them with a two-operand ``lax.sort``.  Torch's uint32 support on
CUDA does not reach that far, so the port joins the planes into ONE int64
*order key*::

    key = ((hi << 32) | lo) ^ (1 << 63)

Flipping the top bit makes signed int64 order equal unsigned 64-bit order,
and the SENTINEL pair becomes ``int64`` max, so padding still sorts last.
The host converts at the boundary (:func:`keys_from_planes`,
:func:`planes_from_keys`); planes made on the device (the device mapper's
rows, int32 bit patterns) join there (:func:`keys_from_plane_tensors`).
"""

from __future__ import annotations

import numpy as np
import torch

from map_oxidize_tpu_torch.obs.compile import observed

#: order key of the padding pair (SENTINEL, SENTINEL): int64 max
SENTINEL_KEY = (1 << 63) - 1
_SIGN64 = np.uint64(1 << 63)
#: the top bit as an int64 scalar, to flip it on device
_SIGN_I64 = -(1 << 63)

_REDUCE = {"min": "amin", "max": "amax"}


def keys_from_planes(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 planes -> int64 order keys (host-side)."""
    k = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return (k ^ _SIGN64).view(np.int64)


def keys_from_plane_tensors(hi: torch.Tensor,
                            lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) planes as int32 (or int64) tensors holding u32 bit patterns
    -> int64 order keys, on the planes' device (torch's uint64 sort on
    CUDA is not relied on)."""
    return (((hi.to(torch.int64) & 0xFFFFFFFF) << 32)
            | (lo.to(torch.int64) & 0xFFFFFFFF)) ^ _SIGN_I64


def plane_tensors_from_keys(keys: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`keys_from_plane_tensors`: int64 order keys ->
    the (hi, lo) planes as int32 bit-pattern tensors, on the keys'
    device."""
    u = keys ^ _SIGN_I64
    return ((u >> 32) & 0xFFFFFFFF).to(torch.int32), (
        u & 0xFFFFFFFF).to(torch.int32)


def planes_from_keys(keys) -> tuple[np.ndarray, np.ndarray]:
    """int64 order keys (array or tensor) -> (hi, lo) uint32 planes."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    k = np.asarray(keys, np.int64).view(np.uint64) ^ _SIGN64
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _identity(combine: str, dtype):
    """Identity element of the combine monoid, as a Python scalar: the fill
    of padding rows and of empty segments.  Integer min/max identities are
    the dtype's true extremum (a float ±inf would not fit)."""
    dtype = torch_dtype(dtype)
    if combine == "sum":
        return 0
    if combine not in ("min", "max"):
        raise ValueError(f"unknown combine {combine!r}")
    if dtype.is_floating_point:
        return -float("inf") if combine == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if combine == "max" else info.max


def make_accumulator(capacity: int, val_shape=(), val_dtype=torch.int32,
                     combine: str = "sum", *, device):
    """A fresh accumulator on ``device`` (no default: the caller names the
    card or the CPU): SENTINEL keys, identity values."""
    val_dtype = torch_dtype(val_dtype)
    keys = torch.full((capacity,), SENTINEL_KEY, dtype=torch.int64,
                      device=device)
    vals = torch.full((capacity,) + tuple(val_shape),
                      _identity(combine, val_dtype), dtype=val_dtype,
                      device=device)
    return keys, vals


def segment_reduce_sorted(keys, vals, combine: str = "sum"):
    """Reduce rows already sorted by key.  Returns ``(uniq_keys, reduced,
    n_unique)`` with unique keys compacted to the front, the rest refilled
    with SENTINEL / the monoid identity, and ``n_unique`` a 0-d int64 tensor
    (no host sync)."""
    n = keys.shape[0]
    new_seg = torch.ones(n, dtype=torch.bool, device=keys.device)
    new_seg[1:] = keys[1:] != keys[:-1]
    seg_ids = torch.cumsum(new_seg, 0) - 1
    n_seg = seg_ids[-1] + 1
    ident = _identity(combine, vals.dtype)
    if combine == "sum" and vals.dtype.is_floating_point:
        # each segment summed in row order, as the JAX package's
        # segment_sum on the CPU: index_add_ on CUDA adds floats with
        # atomics, in an order that changes from run to run
        offsets = torch.searchsorted(
            seg_ids, torch.arange(n + 1, device=keys.device))
        reduced = torch.segment_reduce(vals, "sum", offsets=offsets, axis=0,
                                       unsafe=True, initial=0)
    elif combine == "sum":
        reduced = torch.zeros_like(vals).index_add_(0, seg_ids, vals)
    else:
        # empty segments keep the identity they start from
        idx = seg_ids.view((n,) + (1,) * (vals.ndim - 1)).expand_as(vals)
        reduced = torch.full_like(vals, ident).scatter_reduce_(
            0, idx, vals, reduce=_REDUCE[combine], include_self=True)
    # every row of a segment holds the same key, so any write order is right
    uniq = torch.full_like(keys, SENTINEL_KEY).scatter_(0, seg_ids, keys)
    # padding rows form the final segment; exclude it from the count
    last = uniq.index_select(0, (n_seg - 1).view(1))[0]
    n_unique = n_seg - (last == SENTINEL_KEY).long()
    mask = torch.arange(n, device=keys.device) < n_unique
    uniq = torch.where(mask, uniq, SENTINEL_KEY)
    vmask = mask.view((n,) + (1,) * (reduced.ndim - 1))
    reduced = torch.where(vmask, reduced, ident)
    return uniq, reduced, n_unique


def reduce_pairs(keys, vals, combine: str = "sum"):
    """Stable-sort rows by order key, then segment-combine equal keys.
    ``vals`` is ``[n]`` or ``[n, ...]``; values ride the sort as a
    permutation, so trailing dims are unrestricted."""
    keys_s, perm = torch.sort(keys, stable=True)
    return segment_reduce_sorted(keys_s, vals[perm], combine)


def merge_into_accumulator(acc_keys, acc_vals, ovf, b_keys, b_vals,
                           combine: str = "sum"):
    """Fold one batch into the running accumulator: concatenate the
    accumulator (capacity C) with the batch, reduce, keep the first C rows.

    ``ovf`` is a cumulative dropped-key counter (0-d int64 tensor): keys
    truncated past C add to it, so a later clean merge can never shadow an
    earlier loss, and an *exactly full* accumulator is not an error.
    Returns ``(keys, vals, n_unique, ovf)``."""
    cap = acc_keys.shape[0]
    u_keys, u_vals, n_unique = reduce_pairs(
        torch.cat([acc_keys, b_keys]), torch.cat([acc_vals, b_vals]),
        combine)
    ovf = ovf + (n_unique - cap).clamp_min(0)
    return u_keys[:cap], u_vals[:cap], n_unique, ovf


def merge_batch_into_accumulator(acc_keys, acc_vals, ovf, stacked_keys,
                                 stacked_vals, combine: str = "sum"):
    """Fold B stacked batches (``(B, N)`` keys, ``(B, N, ...)`` values) in
    order — the same result as B calls of :func:`merge_into_accumulator`.
    A dead batch (all SENTINEL keys, identity values) is a no-op.  Returns
    ``(keys, vals, n_unique_of_last_merge, ovf)``."""
    n_unique = None
    for b_keys, b_vals in zip(stacked_keys, stacked_vals):
        acc_keys, acc_vals, n_unique, ovf = merge_into_accumulator(
            acc_keys, acc_vals, ovf, b_keys, b_vals, combine)
    return acc_keys, acc_vals, n_unique, ovf


def unpack_batch(packed):
    """A packed ``(3, N)`` int32 block of u32 bit patterns (hi keys, lo
    keys, int32 values: the JAX package's packed transfer) -> ``(order
    keys, values)`` on the block's device."""
    return keys_from_plane_tensors(packed[0], packed[1]), packed[2]


def merge_packed_into_accumulator(acc_keys, acc_vals, ovf, packed,
                                  combine: str = "sum"):
    """:func:`merge_into_accumulator` of one packed ``(3, N)`` batch of
    scalar int32 values: the host pays ONE copy per flush instead of two
    (JAX ``merge_packed_into_accumulator``)."""
    b_keys, b_vals = unpack_batch(packed)
    return merge_into_accumulator(acc_keys, acc_vals, ovf, b_keys, b_vals,
                                  combine)


def merge_packed_batch_into_accumulator(acc_keys, acc_vals, ovf, stacked,
                                        combine: str = "sum"):
    """:func:`merge_batch_into_accumulator` of B packed batches stacked
    into one ``(B, 3, N)`` copy (JAX ``_merge_packed_batch``)."""
    b_keys, b_vals = unpack_batch(stacked.transpose(0, 1))
    return merge_batch_into_accumulator(acc_keys, acc_vals, ovf, b_keys,
                                        b_vals, combine)


def pack_accumulator_state(keys, vals, n_unique, ovf):
    """Everything finalize needs in ONE ``(3, cap+1)`` int64 tensor with the
    JAX package's packed layout: row 0 = hi keys, row 1 = lo keys, row 2 =
    the 32-bit value bits, and the last column = (n_unique, dropped-key
    count, 0).  Each entry is a uint32 bit pattern held in int64, so
    ``.cpu().numpy().astype(np.uint32)`` is that package's array.  Scalar
    4-byte values only."""
    u = keys ^ _SIGN_I64
    hi = (u >> 32) & 0xFFFFFFFF
    lo = u & 0xFFFFFFFF
    v = vals.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    extra = torch.stack([n_unique.to(torch.int64), ovf.to(torch.int64),
                         torch.zeros((), dtype=torch.int64,
                                     device=keys.device)])
    return torch.cat([torch.stack([hi, lo, v]), extra[:, None]], dim=1)


#: the fold engine's device programs under the launch ledger, by the JAX
#: package's program names (``ops/segment_reduce.py`` :157, :200, :207,
#: :222)
merge = observed("engine/merge", merge_into_accumulator)
merge_packed = observed("engine/merge_packed", merge_packed_into_accumulator)
merge_packed_batch = observed(
    "engine/merge_packed_batch", merge_packed_batch_into_accumulator,
    chunks_of=lambda *a, **kw: a[3].shape[0])
pack_finalize = observed("engine/pack_finalize", pack_accumulator_state)
