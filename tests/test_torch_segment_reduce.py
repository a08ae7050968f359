"""The port's fold (sort + segment-combine, merge, pack) and top-k against
the JAX package's, on the same seeded numpy inputs.  Outputs must be
bit-equal: keys, values (identity fill included), counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_oxidize_tpu.ops import segment_reduce as jsr
from map_oxidize_tpu.ops import topk as jtopk
from map_oxidize_tpu.ops.hashing import SENTINEL, SENTINEL64, split_u64
from map_oxidize_tpu_torch.ops import segment_reduce as tsr
from map_oxidize_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)

COMBINES = ("sum", "min", "max")


def _pairs(rng, n, n_keys, dtype, pad_frac=0.2):
    """Random keys with duplicates (about half with the top bit set), a
    share of SENTINEL padding rows, and random values."""
    pool = rng.integers(0, 2**64, size=n_keys, dtype=np.uint64)
    keys64 = pool[rng.integers(0, n_keys, size=n)]
    keys64[rng.random(n) < pad_frac] = np.uint64(SENTINEL64)
    if np.dtype(dtype) == np.int32:
        vals = rng.integers(-1000, 1000, size=n).astype(np.int32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    hi, lo = split_u64(keys64)
    return hi, lo, vals


def _t(hi, lo):
    return torch.from_numpy(tsr.keys_from_planes(hi, lo))


def _assert_same(port, ref):
    """port: (keys, vals, n) tensors; ref: (hi, lo, vals, n) jax arrays."""
    keys, vals, n = port
    r_hi, r_lo, r_vals, r_n = (np.asarray(a) for a in ref)
    hi, lo = tsr.planes_from_keys(keys)
    np.testing.assert_array_equal(hi, r_hi)
    np.testing.assert_array_equal(lo, r_lo)
    v = vals.numpy()
    assert v.dtype == r_vals.dtype
    # bit patterns: the identity fill (±inf, iinfo extrema) included
    np.testing.assert_array_equal(v.view(np.uint32), r_vals.view(np.uint32))
    assert int(n) == int(r_n)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("combine", COMBINES)
def test_reduce_pairs_matches_jax(combine, dtype):
    rng = np.random.default_rng(11)
    hi, lo, vals = _pairs(rng, 3000, 400, dtype)
    port = tsr.reduce_pairs(_t(hi, lo), torch.from_numpy(vals), combine)
    ref = jsr.reduce_pairs(jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(vals), combine)
    _assert_same(port, ref)
    assert int(port[2]) < 3000  # padding and duplicates collapsed


@pytest.mark.parametrize("combine", COMBINES)
def test_merge_matches_jax(combine):
    """A sequence of merges into a small accumulator, values int32."""
    rng = np.random.default_rng(12)
    cap = 512
    a_keys, a_vals = tsr.make_accumulator(cap, combine=combine, device="cpu")
    ovf = torch.zeros((), dtype=torch.int64)
    j_acc = [jnp.asarray(a) for a in jsr.make_accumulator(cap, combine=combine)]
    j_ovf = jnp.zeros((), jnp.int32)
    for _ in range(4):
        hi, lo, vals = _pairs(rng, 256, 300, np.int32)
        a_keys, a_vals, n, ovf = tsr.merge_into_accumulator(
            a_keys, a_vals, ovf, _t(hi, lo), torch.from_numpy(vals), combine)
        *j_acc, j_n, j_ovf = jsr._merge_impl(
            *j_acc, j_ovf, jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(vals), combine)
        _assert_same((a_keys, a_vals, n), (*j_acc, j_n))
        assert int(ovf) == int(j_ovf)


def test_overflow_is_cumulative_and_matches_jax():
    """Keys past capacity are dropped and counted; a later merge of keys
    that are already resident adds no drop and does not reset the count."""
    rng = np.random.default_rng(13)
    cap = 64
    a_keys, a_vals = tsr.make_accumulator(cap, device="cpu")
    ovf = torch.zeros((), dtype=torch.int64)
    j_acc = [jnp.asarray(a) for a in jsr.make_accumulator(cap)]
    j_ovf = jnp.zeros((), jnp.int32)
    hi, lo, vals = _pairs(rng, 512, 200, np.int32, pad_frac=0.0)
    ovfs = []
    for step in range(2):
        if step == 0:
            b_hi, b_lo, b_vals = hi, lo, vals
        else:  # eight resident keys again
            b_hi, b_lo = tsr.planes_from_keys(a_keys[:8])
            b_vals = vals[:8]
        a_keys, a_vals, n, ovf = tsr.merge_into_accumulator(
            a_keys, a_vals, ovf, _t(b_hi, b_lo), torch.from_numpy(b_vals))
        *j_acc, j_n, j_ovf = jsr._merge_impl(
            *j_acc, j_ovf, jnp.asarray(b_hi), jnp.asarray(b_lo),
            jnp.asarray(b_vals), "sum")
        _assert_same((a_keys, a_vals, n), (*j_acc, j_n))
        assert int(ovf) == int(j_ovf)
        ovfs.append(int(ovf))
    distinct = len(np.unique((hi.astype(np.uint64) << 32) | lo))
    assert ovfs[0] == distinct - cap > 0
    assert ovfs[1] == ovfs[0]


def test_exactly_full_accumulator_is_not_an_error():
    rng = np.random.default_rng(14)
    hi, lo, vals = _pairs(rng, 2000, 128, np.int32, pad_frac=0.0)
    distinct = len(np.unique((hi.astype(np.uint64) << 32) | lo))
    a_keys, a_vals = tsr.make_accumulator(distinct, device="cpu")
    ovf = torch.zeros((), dtype=torch.int64)
    a_keys, a_vals, n, ovf = tsr.merge_into_accumulator(
        a_keys, a_vals, ovf, _t(hi, lo), torch.from_numpy(vals))
    assert int(n) == distinct and int(ovf) == 0
    assert not bool((a_keys == tsr.SENTINEL_KEY).any())


def test_batched_merge_equals_single_merges_and_jax():
    """B stacked batches, one of them dead (all SENTINEL, identity values),
    fold to the same state as B single merges and as the JAX scan."""
    rng = np.random.default_rng(15)
    cap, b, nb = 1024, 3, 256
    planes = [_pairs(rng, nb, 500, np.int32) for _ in range(b - 1)]
    planes.append((np.full(nb, SENTINEL, np.uint32),
                   np.full(nb, SENTINEL, np.uint32), np.zeros(nb, np.int32)))
    keys = torch.stack([_t(h, lo) for h, lo, _ in planes])
    vals = torch.stack([torch.from_numpy(v) for *_, v in planes])
    acc = tsr.make_accumulator(cap, device="cpu")
    zero = torch.zeros((), dtype=torch.int64)
    batched = tsr.merge_batch_into_accumulator(*acc, zero, keys, vals)
    single = (*acc, None, zero)
    for i in range(b):
        single = tsr.merge_into_accumulator(single[0], single[1], single[3],
                                            keys[i], vals[i])
    for x, y in zip(batched, single):
        assert torch.equal(x, y)
    packed = np.stack([np.stack([h, lo, v.view(np.uint32)])
                       for h, lo, v in planes])
    j = jsr._merge_packed_batch(
        *(jnp.asarray(a) for a in jsr.make_accumulator(cap)),
        jnp.zeros((), jnp.int32), jnp.asarray(packed))
    _assert_same(batched[:3], j[:4])


def test_pack_accumulator_state_matches_jax():
    rng = np.random.default_rng(16)
    hi, lo, vals = _pairs(rng, 700, 300, np.int32)
    keys, rvals, n = tsr.reduce_pairs(_t(hi, lo), torch.from_numpy(vals))
    ovf = torch.tensor(7, dtype=torch.int64)
    port = tsr.pack_accumulator_state(keys, rvals, n, ovf)
    j_hi, j_lo, j_vals, j_n = jsr.reduce_pairs(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals))
    ref = np.asarray(jsr.pack_accumulator_state(
        j_hi, j_lo, j_vals, j_n, jnp.asarray(7, jnp.int32)))
    np.testing.assert_array_equal(port.numpy().astype(np.uint32), ref)


@pytest.mark.parametrize("combine,dtype", [("sum", np.int32),
                                           ("min", np.int32),
                                           ("max", np.float32)])
def test_top_k_pairs_ties_and_short_live_rows_match_jax(combine, dtype):
    """Many tied values (selection by value desc, index asc) and k larger
    than the live rows (padding comes back with SENTINEL keys)."""
    rng = np.random.default_rng(17)
    hi, lo, _ = _pairs(rng, 400, 60, dtype, pad_frac=0.0)
    vals = rng.integers(0, 4, size=400).astype(dtype)  # heavy ties
    keys, rvals, n = tsr.reduce_pairs(_t(hi, lo), torch.from_numpy(vals),
                                      combine)
    j_hi, j_lo, j_vals, _ = jsr.reduce_pairs(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals), combine)
    live = int(n)
    for k in (10, live + 5):
        t_keys, t_vals = ttopk.top_k_pairs(keys, rvals, k)
        r_hi, r_lo, r_vals = jtopk.top_k_pairs(j_hi, j_lo, j_vals, k)
        t_hi, t_lo = tsr.planes_from_keys(t_keys)
        np.testing.assert_array_equal(t_hi, np.asarray(r_hi))
        np.testing.assert_array_equal(t_lo, np.asarray(r_lo))
        np.testing.assert_array_equal(t_vals.numpy(), np.asarray(r_vals))
    assert (t_hi[live:] == SENTINEL).all() and (t_lo[live:] == SENTINEL).all()
