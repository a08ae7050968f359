"""The port's mesh, exchange and sharded engines against the JAX package's
``parallel/`` on the same inputs: the ten cases of ``tests/test_parallel.py``
with each port engine's state (the per-shard accumulators in the JAX
layout, the overflow and unique counts) bit-equal to the JAX engine's at
the same S; ``bucket_of`` / ``range_dest`` on random planes (SENTINEL and
keys equal to a splitter among them); ``_exchange`` under both wire
programs (the same rows and overflow, and the JAX counts); a tie-heavy
two-level top-k; the sharded collect for hash and range partitions; and
the mesh itself (the real and virtual pools, the collectives' order, the
slot-device check).  The port runs on S CPU slots, the JAX package on its
8 forced CPU devices."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from map_oxidize_tpu.api import MapOutput as JaxMapOutput
from map_oxidize_tpu.api import MinReducer as JaxMin
from map_oxidize_tpu.api import SumReducer as JaxSum
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.ops.hashing import HashDictionary as JaxDict
from map_oxidize_tpu.parallel import ShardedReduceEngine as JaxSharded
from map_oxidize_tpu.parallel import make_mesh as jax_make_mesh
from map_oxidize_tpu.parallel.shuffle import _exchange as jax_exchange
from map_oxidize_tpu.parallel.shuffle import bucket_of as jax_bucket_of
from map_oxidize_tpu.parallel.shuffle import range_dest as jax_range_dest
from map_oxidize_tpu.utils.jax_compat import shard_map
from map_oxidize_tpu_torch.api import MapOutput, MinReducer, SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs.dataplane import partition_of
from map_oxidize_tpu_torch.ops.hashing import (
    SENTINEL,
    SENTINEL64,
    HashDictionary,
    join_u64,
)
from map_oxidize_tpu_torch.ops.segment_reduce import (
    keys_from_planes,
    planes_from_keys,
)
from map_oxidize_tpu_torch.parallel import (
    ShardedReduceEngine,
    ShuffleOverflowError,
    make_mesh,
)
from map_oxidize_tpu_torch.parallel.mesh import (
    all_gather,
    all_to_all,
    psum,
    real_pool,
)
from map_oxidize_tpu_torch.parallel.shuffle import (
    _exchange,
    bucket_of,
    range_dest,
)

torch.set_num_threads(2)


def _rows(rng, n, key_space):
    keys = rng.integers(0, key_space, size=n, dtype=np.uint64)
    keys = np.where(keys == np.uint64(SENTINEL64), np.uint64(0), keys)
    vals = rng.integers(1, 10, size=n, dtype=np.int32)
    return _planes(keys) + (vals, keys)


def _planes(keys):
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _truth(keys, vals, combine="sum"):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out[k] = (out.get(k, 0) + v if combine == "sum"
                  else min(out.get(k, 1 << 62), v))
    return out


def _readback(engine):
    hi, lo, vals, n = engine.finalize()
    hi, lo, vals = np.asarray(hi), np.asarray(lo), np.asarray(vals)
    live = ~((hi == np.uint32(SENTINEL)) & (lo == np.uint32(SENTINEL)))
    return dict(zip(join_u64(hi[live], lo[live]).tolist(),
                    [v.tolist() for v in vals[live]])), n


def _pair(S, feeds, reducer="sum", value_shape=(), value_dtype=np.int32,
          **kw):
    """The same feeds through the port's and the JAX package's sharded
    engines at S shards, staged rows flushed; returns both engines."""
    cfg = dict(backend="cpu", num_shards=S, **kw.pop("cfg"))
    port = ShardedReduceEngine(
        JobConfig(**cfg), {"sum": SumReducer, "min": MinReducer}[reducer](),
        value_shape=value_shape, value_dtype=value_dtype, **kw)
    jax_eng = JaxSharded(
        JaxJobConfig(**cfg), {"sum": JaxSum, "min": JaxMin}[reducer](),
        value_shape=value_shape, value_dtype=value_dtype,
        mesh=jax_make_mesh(S, "cpu"), **kw)
    for hi, lo, vals in feeds:
        port.feed(MapOutput(hi=hi, lo=lo, values=vals,
                            dictionary=HashDictionary()))
        jax_eng.feed(JaxMapOutput(hi=hi, lo=lo, values=vals,
                                  dictionary=JaxDict()))
    port.flush()
    jax_eng.flush()
    return port, jax_eng


def _same_state(port, jax_eng):
    """Per-shard accumulators, overflow and unique counts bit-equal."""
    a, b = port.export_state(), jax_eng.export_state()
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


# --- the ten cases of tests/test_parallel.py ------------------------------


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_sharded_matches_truth_and_jax(rng, S):
    hi, lo, vals, keys = _rows(rng, 3000, key_space=500)
    feeds = [(hi[s], lo[s], vals[s]) for s in (
        slice(0, 1000), slice(1000, 1700), slice(1700, 3000))]
    port, jax_eng = _pair(S, feeds, cfg=dict(batch_size=512,
                                             key_capacity=4096))
    _same_state(port, jax_eng)
    got, n = _readback(port)
    want = _truth(keys, vals)
    assert got == want and n == len(want)


def test_sharded_matches_single_device(rng):
    from map_oxidize_tpu_torch.runtime.engine import DeviceReduceEngine

    cfg = JobConfig(batch_size=256, key_capacity=2048, backend="cpu",
                    num_shards=8)
    hi, lo, vals, _keys = _rows(rng, 2000, key_space=300)
    out = MapOutput(hi=hi, lo=lo, values=vals, dictionary=HashDictionary())
    sharded = ShardedReduceEngine(cfg, SumReducer())
    sharded.feed(out)
    single = DeviceReduceEngine(cfg, SumReducer(), device="cpu")
    single.feed(out)
    assert _readback(sharded) == _readback(single)


@pytest.mark.parametrize("S", [2, 3, 8])
def test_sharded_topk_matches_jax(rng, S):
    hi, lo, vals, keys = _rows(rng, 4000, key_space=200)
    port, jax_eng = _pair(S, [(hi, lo, vals)],
                          cfg=dict(batch_size=512, key_capacity=4096))
    p = port.top_k(10)
    j = jax_eng.top_k(10)
    for x, y in zip(p, j):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    truth = _truth(keys, vals)
    want = sorted(truth.values(), reverse=True)[:10]
    assert sorted(p[2].tolist(), reverse=True) == want


def test_sharded_min_monoid(rng):
    hi, lo, vals, keys = _rows(rng, 1500, key_space=100)
    port, jax_eng = _pair(4, [(hi, lo, vals)], reducer="min",
                          cfg=dict(batch_size=256, key_capacity=2048))
    _same_state(port, jax_eng)
    assert _readback(port)[0] == _truth(keys, vals, "min")


def test_skewed_batch_no_overflow(rng):
    n = 512
    keys = rng.integers(0, 260, size=n, dtype=np.uint64)
    keys[: n // 2] = 7  # one key is half the batch
    vals = np.ones(n, np.int32)
    port, jax_eng = _pair(8, [_planes(keys) + (vals,)],
                          cfg=dict(batch_size=512, key_capacity=4096))
    _same_state(port, jax_eng)
    assert _readback(port)[0] == _truth(keys, vals)


def test_padding_does_not_count_toward_bucket_overflow():
    keys = np.arange(8, dtype=np.uint64)  # one key per bucket
    vals = np.full(8, 5, np.int32)
    port, jax_eng = _pair(8, [_planes(keys) + (vals,)], bucket_cap=3,
                          cfg=dict(batch_size=512, key_capacity=4096))
    _same_state(port, jax_eng)
    got, n = _readback(port)
    assert got == _truth(keys, vals) and n == 8


def test_real_bucket_overflow_still_raises():
    keys = np.arange(8, dtype=np.uint64) << np.uint64(3)  # all bucket 0
    vals = np.ones(8, np.int32)
    port, jax_eng = _pair(8, [_planes(keys) + (vals,)], bucket_cap=3,
                          cfg=dict(batch_size=512, key_capacity=4096))
    assert (port.export_state()["ovf"].tolist()
            == np.asarray(jax_eng.export_state()["ovf"]).tolist() == [5] * 8)
    with pytest.raises(ShuffleOverflowError):
        port.finalize()


def test_topk_wider_than_shard_capacity(rng):
    n = 400
    keys = np.concatenate([rng.permutation(40).astype(np.uint64)] * 10)[:n]
    vals = np.ones(n, np.int32)
    port, jax_eng = _pair(8, [_planes(keys) + (vals,)],
                          cfg=dict(batch_size=512, key_capacity=64))
    t_hi, t_lo, t_vals, cnt = port.top_k(30)  # 30 > capacity per shard
    j = jax_eng.top_k(30)
    np.testing.assert_array_equal(t_vals, np.asarray(j[2]))
    np.testing.assert_array_equal(t_hi, np.asarray(j[0]))
    assert cnt == 40
    live = {h: v for h, v in zip(join_u64(t_hi, t_lo).tolist(),
                                 t_vals.tolist()) if v > 0}
    assert len(live) == 30


def test_driver_e2e_sharded(tmp_path, rng):
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
    from map_oxidize_tpu_torch.workloads.reference_model import (
        wordcount_model,
    )
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    corpus = tmp_path / "c.txt"
    words = ["The", "the", "fox,", "dog", "a", "over", "Lazy"]
    text = "\n".join(" ".join(rng.choice(words, size=9)) for _ in range(200))
    corpus.write_text(text)
    cfg = JobConfig(input_path=str(corpus),
                    output_path=str(tmp_path / "o.txt"), backend="cpu",
                    num_shards=8, batch_size=256, key_capacity=1024,
                    use_native=False)
    mapper, reducer = make_wordcount("ascii", use_native=False)
    res = run_wordcount_job(cfg, mapper, reducer)
    assert res.counts == dict(wordcount_model([text.encode()]))
    assert res.metrics["accumulator_device"] == "cpu"


def test_sharded_vector_values(rng):
    n = 1000
    keys = rng.integers(0, 50, size=n, dtype=np.uint64)
    vecs = rng.normal(size=(n, 3)).astype(np.float32)
    port, jax_eng = _pair(4, [_planes(keys) + (vecs,)], value_shape=(3,),
                          value_dtype=np.float32,
                          cfg=dict(batch_size=256, key_capacity=1024))
    got, cnt = _readback(port)
    want, _ = _readback(jax_eng)
    assert got.keys() == want.keys() and cnt == len(np.unique(keys))
    for k in got:
        # per-key f32 sums over the same pre-combined rows; the fold order
        # is the sorted-segment order in both packages
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


# --- routing ------------------------------------------------------------------


def _random_planes(rng, n):
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    hi[:3] = SENTINEL
    lo[:3] = SENTINEL
    hi[3:6] = 0
    lo[3:6] = np.uint32(1 << 31)
    return hi, lo


@pytest.mark.parametrize("S", [2, 3, 8])
def test_bucket_of_matches_jax_and_the_audit_partition(rng, S):
    hi, lo = _random_planes(rng, 4096)
    got = bucket_of(torch.from_numpy(keys_from_planes(hi, lo)), S).numpy()
    want = np.asarray(jax_bucket_of(jnp.asarray(hi), jnp.asarray(lo), S))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, partition_of(join_u64(hi, lo), S))


@pytest.mark.parametrize("S", [2, 3, 8])
def test_range_dest_matches_jax(rng, S):
    hi, lo = _random_planes(rng, 4096)
    keys = join_u64(hi, lo)
    sp = np.sort(rng.choice(keys[6:], S - 1, replace=False))
    sp[0] = np.uint64(1 << 31)  # keys equal to a splitter (rows 3-5)
    sp = np.sort(sp)
    sp_hi, sp_lo = _planes(sp)
    want = np.asarray(jax_range_dest(jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(sp_hi), jnp.asarray(sp_lo)))
    got = range_dest(torch.from_numpy(keys_from_planes(hi, lo)),
                     torch.from_numpy(keys_from_planes(sp_hi, sp_lo)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.searchsorted(sp, keys, "right"))


def _jax_exchange(S, cap, hi, lo, vals, method):
    mesh = jax_make_mesh(S, "cpu")
    spec = P("shards")

    def body(h, l, v):
        r_h, r_l, r_v, ovf = jax_exchange(h, l, v, S, cap, method=method)
        return r_h, r_l, r_v, ovf[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=(spec,) * 4))
    r_h, r_l, r_v, ovf = f(hi, lo, vals)
    return (np.asarray(r_h).reshape(S, -1), np.asarray(r_l).reshape(S, -1),
            np.asarray(r_v).reshape(S, -1), np.asarray(ovf))


@pytest.mark.parametrize("S,cap", [(2, 40), (3, 9), (8, 3), (8, 64)])
def test_exchange_gives_the_jax_rows_under_both_methods(rng, S, cap):
    B = 64  # rows per shard, a tail of them SENTINEL padding
    keys = rng.integers(0, 1 << 64, S * B, dtype=np.uint64)
    keys[B - 10:B] = SENTINEL64
    keys[-7:] = SENTINEL64
    hi, lo = _planes(keys)
    vals = rng.integers(0, 100, S * B, dtype=np.int32)
    mesh = make_mesh(S, "cpu")
    k_sh = mesh.split(torch.from_numpy(keys_from_planes(hi, lo)))
    v_sh = mesh.split(torch.from_numpy(vals))
    got = {}
    for method in ("all_to_all", "all_gather"):
        r_k, r_v, ovf = _exchange(mesh, k_sh, v_sh, cap, method=method)
        j_h, j_l, j_v, j_ovf = _jax_exchange(S, cap, hi, lo, vals, method)
        for s in range(S):
            p_h, p_l = planes_from_keys(r_k[s])
            np.testing.assert_array_equal(p_h, j_h[s])
            np.testing.assert_array_equal(p_l, j_l[s])
            np.testing.assert_array_equal(r_v[s].numpy(), j_v[s])
        assert [int(o) for o in ovf] == j_ovf.tolist()
        got[method] = ([k.numpy() for k in r_k], [v.numpy() for v in r_v],
                       [int(o) for o in ovf])
    for a, b in zip(got["all_to_all"], got["all_gather"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if cap == 3:
        assert got["all_to_all"][2][0] > 0  # real rows were dropped


@pytest.mark.parametrize("S", [3, 8])
def test_tie_heavy_topk_selects_as_jax(S):
    """Every value tied across shards, floor-valued real keys beside
    padding: the final select takes live rows first among equal values
    and the HIGHER gathered index first, as JAX's ``lexsort``."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(np.arange(1, 90, dtype=np.uint64))
    vals = (keys % np.uint64(3)).astype(np.int32)  # 0, 1, 2: heavy ties
    port, jax_eng = _pair(S, [_planes(keys) + (vals,)], reducer="min",
                          cfg=dict(batch_size=128, key_capacity=256))
    for k in (5, 17, 40, 200):
        p = port.top_k(k)
        j = jax_eng.top_k(k)
        for x, y in zip(p, j):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- the sharded collect ------------------------------------------------------


def _pairs(rng, n, key_space):
    keys = rng.integers(0, key_space, n, dtype=np.uint64)
    docs = np.sort(rng.integers(0, 1 << 62, n)).astype(np.int64)
    k_hi, k_lo = _planes(keys)
    d_hi, d_lo = _planes(docs.view(np.uint64))
    return keys, docs, MapOutput(hi=k_hi, lo=k_lo,
                                 values=np.stack([d_hi, d_lo], 1),
                                 dictionary=HashDictionary())


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("splitters", [False, True])
def test_sharded_collect_matches_jax(rng, S, splitters):
    from map_oxidize_tpu.parallel.collect import (
        ShardedCollectEngine as JaxCollect,
    )
    from map_oxidize_tpu_torch.parallel.collect import ShardedCollectEngine
    from map_oxidize_tpu_torch.workloads.sort import compute_splitters

    keys, docs, out = _pairs(rng, 5000, 700)
    sp = compute_splitters(keys, S) if splitters else None
    cfg = dict(backend="cpu", num_shards=S, batch_size=1024)
    port = ShardedCollectEngine(JobConfig(**cfg), splitters=sp,
                                pair_order="lex")
    jax_eng = JaxCollect(JaxJobConfig(**cfg), mesh=jax_make_mesh(S, "cpu"),
                         splitters=sp, pair_order="lex")
    for sl in (slice(0, 1500), slice(1500, 5000)):
        part = MapOutput(hi=out.hi[sl], lo=out.lo[sl],
                         values=out.values[sl], dictionary=HashDictionary())
        port.feed(part)
        jax_eng.feed(JaxMapOutput(hi=out.hi[sl], lo=out.lo[sl],
                                  values=out.values[sl],
                                  dictionary=JaxDict()))
    pk, pd = port.finalize()
    jk, jd = jax_eng.finalize()
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pd, jd)
    if splitters:  # range runs concatenate in the global order
        assert (np.diff(pk.astype(np.float64)) >= 0).all()
    assert sorted(zip(pk.tolist(), pd.tolist())) == sorted(
        zip(keys.tolist(), docs.tolist()))


def test_sharded_collect_demotes_to_the_host_like_jax(rng):
    """Past ``collect_max_rows`` under ``hybrid`` both engines drain their
    shards into the host engine at the same row, with the same
    ``demote/*`` and ``spill/*`` records and the same output."""
    from map_oxidize_tpu.obs import Obs as JaxObs
    from map_oxidize_tpu.parallel.collect import (
        ShardedCollectEngine as JaxCollect,
    )
    from map_oxidize_tpu_torch.obs import Obs
    from map_oxidize_tpu_torch.parallel.collect import ShardedCollectEngine

    keys, docs, out = _pairs(rng, 6000, 900)
    cfg = dict(backend="cpu", num_shards=8, batch_size=512,
               shuffle_transport="hybrid", metrics=False)
    engines = {
        "port": ShardedCollectEngine(JobConfig(**cfg), max_rows=2500),
        "jax": JaxCollect(JaxJobConfig(**cfg), max_rows=2500,
                          mesh=jax_make_mesh(8, "cpu")),
    }
    obs = {"port": Obs.from_config(JobConfig(**cfg)),
           "jax": JaxObs.from_config(JaxJobConfig(**cfg))}
    res = {}
    for pkg, eng in engines.items():
        eng.obs = obs[pkg]
        mo = MapOutput if pkg == "port" else JaxMapOutput
        dd = HashDictionary if pkg == "port" else JaxDict
        for s in range(0, 6000, 1000):
            eng.feed(mo(hi=out.hi[s:s + 1000], lo=out.lo[s:s + 1000],
                        values=out.values[s:s + 1000], dictionary=dd()))
        assert eng.spilled
        runs = list(eng.finalize_spilled_runs())
        res[pkg] = (np.concatenate([k for k, _ in runs]),
                    np.concatenate([d for _, d in runs]))
        c = obs[pkg].registry.counters
        res[pkg + "_m"] = {k: v for k, v in c.items()
                           if k.startswith(("demote/", "spill/rows",
                                            "spill/buckets"))}
    for a, b in zip(res["port"], res["jax"]):
        np.testing.assert_array_equal(a, b)
    assert res["port_m"] == res["jax_m"]
    assert res["port_m"]["demote/rows"] == 3000  # the triggering block's
    # rows are not counted twice: demotion at the third 1000-row feed


# --- the mesh -----------------------------------------------------------------


def test_num_shards_zero_is_the_real_pool_and_more_is_virtual():
    from map_oxidize_tpu_torch.runtime.driver import effective_num_shards

    assert real_pool("cpu") == [torch.device("cpu")]
    assert make_mesh(0, "cpu").size == 1
    assert effective_num_shards(JobConfig(backend="cpu")) == 1
    assert effective_num_shards(JobConfig(backend="cuda")) == max(
        torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1
    m = make_mesh(8, "cpu")
    assert m.size == 8 and m.single_device and m.shape == {"shards": 8}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(8, "cuda")


def test_collectives_keep_shard_order_and_check_devices():
    m = make_mesh(3, "cpu")
    xs = [torch.full((2,), float(s)) for s in range(3)]
    assert all(g.tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
               for g in all_gather(m, xs, tiled=True))
    bufs = [torch.arange(3) + 10 * s for s in range(3)]  # [dst] rows
    out = all_to_all(m, bufs)
    assert [o.tolist() for o in out] == [[0, 10, 20], [1, 11, 21],
                                         [2, 12, 22]]
    # psum is a left fold in shard order: ((a + b) + c), bit for bit
    a = torch.tensor([1e8], dtype=torch.float32)
    b = torch.tensor([1.0], dtype=torch.float32)
    c = torch.tensor([-1e8], dtype=torch.float32)
    got = psum(m, [a, b, c])
    assert got[0].item() == ((a + b) + c).item()
    assert got[0] is got[1] is got[2]
    with pytest.raises(RuntimeError, match="not on its slot's device"):
        m.check([torch.zeros(1), torch.zeros(1, device="meta"),
                 torch.zeros(1)])
