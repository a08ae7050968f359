"""Device top-k over reduced (key, value) pairs.

Selection is by (value descending, index ascending), as ``lax.top_k`` selects
in the JAX package.  ``torch.topk`` does not promise that tie order, so the
port takes the first ``k`` rows of a *stable* descending sort.  The
accumulator's rows are key-sorted, so ties break by ascending key hash.
"""

from __future__ import annotations

import numpy as np
import torch

from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.segment_reduce import SENTINEL_KEY


def _mask_floor(vals):
    """The value no real row can beat downward: dtype minimum (or -inf)."""
    if vals.dtype.is_floating_point:
        return -float("inf")
    return torch.iinfo(vals.dtype).min


def mask_padding(keys, vals):
    """Sink padding rows (SENTINEL keys) to the dtype floor so they lose
    under ANY monoid — a min-monoid's identity is the dtype MAX, which would
    otherwise outrank every real key.  Real rows that hold the floor value
    tie with padding; live rows are compacted to the front, and ties go to
    the lowest index, so they win."""
    return torch.where(keys == SENTINEL_KEY, _mask_floor(vals), vals)


def top_k_pairs(keys, vals, k: int):
    """Top-``k`` rows by value (descending), any monoid.  Returns
    ``(keys_k, vals_k)``; when fewer than ``k`` live rows exist, the tail
    rows carry SENTINEL keys and the floor value."""
    if vals.ndim != 1:
        raise ValueError("top_k_pairs expects scalar per-key values")
    top_vals, idx = torch.sort(mask_padding(keys, vals), descending=True,
                               stable=True)
    return keys[idx[:k]], top_vals[:k]


#: :func:`top_k_pairs` under the launch ledger (JAX ``ops/topk.py:59``)
top_k = observed("engine/top_k", top_k_pairs)


def top_k_candidate_indices(vals, k: int):
    """Host-side top-k candidate set: indices of every value >= the k-th
    largest (argpartition threshold).

    Returning the full tied boundary — not argpartition's arbitrary top-k
    subset — is what makes a deterministic tie-break possible: the caller
    sorts the candidates with its own secondary key (word bytes) and
    truncates to ``k``."""
    n = int(vals.shape[0])
    if n == 0:
        return np.empty(0, np.int64)
    if n <= k:
        return np.arange(n)
    kth = np.partition(vals, n - k)[n - k]
    return np.nonzero(vals >= kth)[0]
