"""The port's shuffle layer against the JAX package's: the transport router
and the state machine of every transport, the demotion and spill records,
the map-side combiner, the top-bits disk partition and the pair stage's
drains, the pair half of the data-plane audit,
the native bindings the collect route uses, and ``HostCollectReduceEngine``
for the sum, min and max reducers, in RAM and spilled.  Same seeded inputs
through both packages, compared exactly."""

import types

import numpy as np
import pytest
import torch

from map_oxidize_tpu import shuffle as jshuffle
from map_oxidize_tpu.api import MapOutput as JaxMapOutput
from map_oxidize_tpu.api import Reducer as JaxReducer
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.native import build as jbuild
from map_oxidize_tpu.obs import dataplane as jdataplane
from map_oxidize_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from map_oxidize_tpu.obs.trace import Tracer as JaxTracer
from map_oxidize_tpu.runtime import spill as jspill
from map_oxidize_tpu.runtime.host_reduce import (
    HostCollectReduceEngine as JaxHostEngine,
)
from map_oxidize_tpu_torch import shuffle as tshuffle
from map_oxidize_tpu_torch.api import MapOutput, Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.native import build as tbuild
from map_oxidize_tpu_torch.obs import dataplane as tdataplane
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
from map_oxidize_tpu_torch.obs.trace import Tracer
from map_oxidize_tpu_torch.runtime import spill as tspill
from map_oxidize_tpu_torch.runtime.host_reduce import HostCollectReduceEngine

torch.set_num_threads(2)


def _obs(pkg):
    reg, tr = ((MetricsRegistry(), Tracer(enabled=True)) if pkg == "port"
               else (JaxRegistry(), JaxTracer(enabled=True)))
    return types.SimpleNamespace(registry=reg, tracer=tr, dataplane=None,
                                 dataplane_enabled=True)


def _keys(seed, n=20000, distinct=3000):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, size=distinct, dtype=np.uint64)
    return pool[rng.zipf(1.3, size=n) % distinct]


# --- the router and the state machines --------------------------------------


@pytest.mark.parametrize("name", ["auto", "hbm", "disk", "hybrid",
                                  "pipelined", "remote"])
@pytest.mark.parametrize("size", [100, 10_000])
def test_resolve_transport_matches_jax(tmp_path, name, size):
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"x" * size)
    for cap in (10, 1000, 1 << 27):
        got = tshuffle.resolve_transport(
            JobConfig(input_path=str(inp), shuffle_transport=name), cap)
        want = jshuffle.resolve_transport(
            JaxJobConfig(input_path=str(inp), shuffle_transport=name), cap)
        assert got == want


@pytest.mark.parametrize("name", ["hbm", "disk", "hybrid", "pipelined",
                                  "remote"])
def test_transport_verdicts_match_jax(name):
    mine, ref = tshuffle.make_transport(name), jshuffle.make_transport(name)
    assert mine.name == ref.name == name
    for rows in (1, 50, 99, 100, 101, 150, 10, 500):
        try:
            want = ref.admit(rows, 100, "e")
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="--shuffle-transport"):
                mine.admit(rows, 100, "e")
            assert name == "hbm" and "--shuffle-transport" in str(e)
            continue
        assert mine.admit(rows, 100, "e") == want
        assert mine.spilled_state == ref.spilled_state
    with pytest.raises(ValueError, match="unknown shuffle transport"):
        tshuffle.make_transport("auto")
    assert tshuffle.TRANSPORTS == jshuffle.TRANSPORTS


def test_demotion_record_matches_jax():
    docs = {}
    for pkg, mod in (("port", tshuffle), ("jax", jshuffle)):
        obs = _obs(pkg)
        with mod.record_demotion(obs, 1234, "ram", "disk", max_rows=7):
            pass
        with mod.record_demotion(obs, 6, "ram", "disk"):
            pass
        ev = [(e["name"], e["args"]) for e in obs.tracer.chrome_trace()
              if e["name"] == "shuffle/demote"]
        docs[pkg] = obs.registry.summary(), ev
    assert docs["port"] == docs["jax"]
    assert docs["port"][0]["demote/events"] == 2
    assert docs["port"][0]["demote/rows"] == 1240


# --- the map-side combiner --------------------------------------------------


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
@pytest.mark.parametrize("form", ["planes", "compact"])
def test_combine_map_output_matches_jax(combine, form):
    keys = _keys(1, n=5000, distinct=400)
    vals = np.random.default_rng(2).integers(-50, 50, 5000).astype(np.int32)
    if form == "compact" and combine != "sum":
        vals = None
    outs = []
    for cls, mod in ((MapOutput, tshuffle), (JaxMapOutput, jshuffle)):
        if form == "compact":
            out = cls(hi=None, lo=None,
                      values=None if vals is None else vals.copy(),
                      records_in=5000, keys64=keys.copy())
        else:
            out = cls(hi=(keys >> np.uint64(32)).astype(np.uint32),
                      lo=keys.astype(np.uint32), values=vals.copy(),
                      records_in=5000)
        if vals is None and combine != "sum":
            with pytest.raises(ValueError, match="sum"):
                mod.combine_map_output(out, combine)
            return
        outs.append(mod.combine_map_output(out, combine))
    (a, ai, ao), (b, bi, bo) = outs
    assert (ai, ao) == (bi, bo) and ao < ai
    for f in ("hi", "lo", "values", "keys64"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.records_in == b.records_in == 5000
    regs = [MetricsRegistry(), JaxRegistry()]
    tshuffle.record_push_combine(types.SimpleNamespace(registry=regs[0]),
                                 ai, ao)
    jshuffle.record_push_combine(types.SimpleNamespace(registry=regs[1]),
                                 bi, bo)
    assert regs[0].summary() == regs[1].summary()


# --- the top-bits partition and the pair stage ------------------------------


def test_partition_top_bits_matches_jax(tmp_path):
    keys = _keys(3)
    for bits in (1, 4, 8):
        got = tspill.partition_top_bits(keys, bits)
        want = jspill.partition_top_bits(keys, bits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tspill.DEFAULT_BITS == jspill.DEFAULT_BITS


def _stage_pairs(mod, pkg, keys, docs, bits):
    obs = _obs(pkg)
    st = mod.DiskPairStage(bits, obs=obs)
    for lo in range(0, keys.shape[0], 3000):
        st.add(keys[lo:lo + 3000], docs[lo:lo + 3000])
    return st, obs


def _stable(keys, docs):
    o = np.argsort(keys, kind="stable")
    return keys[o], docs[o]


@pytest.mark.parametrize("drain", ["csr", "sorted"])
def test_disk_pair_stage_drains_match_jax(drain):
    keys = _keys(4)
    docs = np.random.default_rng(5).integers(0, 2**40, keys.shape[0])
    got = {}
    for pkg, mod in (("port", tshuffle), ("jax", jshuffle)):
        st, obs = _stage_pairs(mod, pkg, keys, docs, 4)
        assert st.rows == keys.shape[0] and st.bytes == 16 * keys.shape[0]
        if drain == "csr":
            terms, offs, d, holder, peak = st.drain_csr(_stable)
            got[pkg] = (terms.copy(), offs.copy(), np.array(d), peak)
            holder.cleanup()
        else:
            runs = list(st.drain_sorted(_stable))
            got[pkg] = tuple(np.concatenate([r[i] for r in runs])
                             for i in range(2))
        summary = obs.registry.summary()
        assert summary.pop("spill/io_ms") >= 0  # wall time: not compared
        got[pkg] += (summary,)
    for g, w in zip(got["port"], got["jax"]):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    k = got["port"][0]
    assert np.all(k[1:] >= k[:-1])  # buckets drain key-ascending


def test_a_corrupted_spill_raises_conservation_error():
    keys = _keys(6, n=4000)
    docs = np.arange(4000, dtype=np.int64)
    for pkg, mod, err in (
            ("port", tshuffle, tdataplane.ConservationError),
            ("jax", jshuffle, jdataplane.ConservationError)):
        st, _ = _stage_pairs(mod, pkg, keys, docs, 2)
        real_take = st.files.take

        def take(suffix, i, dtype, _real=real_take):
            rec = _real(suffix, i, dtype)
            if rec is not None and i == 1:
                rec = rec[:-1]  # one record lost on disk
            return rec

        st.files.take = take
        with pytest.raises(err, match="spill conservation violated"):
            list(st.drain_sorted(_stable))


# --- the pair half of the data-plane audit ----------------------------------


def test_pair_digest_and_audit_match_jax():
    keys = _keys(9, n=6000)
    docs = np.random.default_rng(10).integers(0, 2**62, 6000)
    assert tdataplane.pair_digest(keys, docs) == jdataplane.pair_digest(
        keys, docs)
    va = np.stack([(docs >> 32).astype(np.uint32),
                   docs.astype(np.uint32)], axis=1)
    for cls, mod in ((MapOutput, tdataplane), (JaxMapOutput, jdataplane)):
        out = cls(hi=(keys >> np.uint64(32)).astype(np.uint32),
                  lo=keys.astype(np.uint32), values=va)
        k, d = mod.map_output_rows(out, pairs=True)
        np.testing.assert_array_equal(k, keys)
        np.testing.assert_array_equal(d, docs)
    audits = (tdataplane.DataPlaneAudit(1), jdataplane.DataPlaneAudit(1))
    order = np.lexsort((docs, keys))
    for a in audits:
        a.record_pairs_in(keys[:3000], docs[:3000])
        a.record_pairs_in(keys[3000:], docs[3000:])
        a.record_pairs_out(keys[order], docs[order])
        a.set_records_in(6000)
        a.check_pairs()
    got, want = (a.doc() for a in audits)
    assert got == want and got["conservation"]["violations"] == []
    regs = [MetricsRegistry(), JaxRegistry()]
    for a, r in zip(audits, regs):
        a.publish(r)
    assert regs[0].summary() == regs[1].summary()
    bad = tdataplane.DataPlaneAudit(1)
    bad.record_pairs_in(keys, docs)
    bad.record_pairs_out(keys, docs + 1)
    with pytest.raises(tdataplane.ConservationError, match="pair"):
        bad.check_pairs()


# --- the native bindings of the collect route ---------------------------------


def _text(seed=11, lines=2000):
    rng = np.random.default_rng(seed)
    words = [b"w%dQ" % i for i in range(500)]
    z = rng.zipf(1.2, size=(lines, 8)) % 500
    return b"\n".join(b" ".join(words[j] for j in r) for r in z) + b"\n"


@pytest.mark.parametrize("entry", ["docs", "hashes", "hll", "bigram"])
def test_native_entry_points_match_the_jax_bindings(tmp_path, entry):
    data = _text()
    path = tmp_path / "c.txt"
    path.write_bytes(data)
    t, j = tbuild.NativeStream(2 if entry == "bigram" else 1), \
        jbuild.NativeStream(2 if entry == "bigram" else 1)
    if entry == "docs":
        a, b = t.map_docs(data, 77), j.map_docs(data, 77)
        np.testing.assert_array_equal(a.keys64, b.keys64)
        np.testing.assert_array_equal(a.docs64, b.docs64)
        assert a.records_in == b.records_in
        fa = [(o.keys64, o.docs64, off) for o, off in
              t.iter_file_docs(str(path), 4096)]
        fb = [(o.keys64, o.docs64, off) for o, off in
              j.iter_file_docs(str(path), 4096)]
    elif entry == "hashes":
        a, b = t.map_chunk_hashes(data), j.map_chunk_hashes(data)
        np.testing.assert_array_equal(a.keys64, b.keys64)
        fa = [(o.keys64, off) for o, off in t.iter_file_hashes(str(path),
                                                              4096)]
        fb = [(o.keys64, off) for o, off in j.iter_file_hashes(str(path),
                                                              4096)]
    elif entry == "hll":
        for p in (11, 14):
            np.testing.assert_array_equal(t.map_chunk_hll(data, p)[0],
                                          j.map_chunk_hll(data, p)[0])
        fa = list(t.iter_file_hll(str(path), 4096, 12))
        fb = list(j.iter_file_hll(str(path), 4096, 12))
    else:
        a = tbuild.load_native().map_bigram(data)
        b = jbuild.load_native().map_bigram(data)
        np.testing.assert_array_equal(a.hi, b.hi)
        np.testing.assert_array_equal(a.values, b.values)
        assert dict(a.dictionary.items()) == dict(b.dictionary.items())
        for s in (t, j):  # the dictionary drained apart from the map
            s.map_chunk(data, drain_dict=False)
        assert (dict(t.drain_dictionary().items())
                == dict(j.drain_dictionary().items())
                == dict(a.dictionary.items()))
        assert len(t.drain_dictionary()) == 0
        want = np.unique(a.hi.astype(np.uint64) << np.uint64(32)
                         | a.lo)[:50]
        fa = [t.resolve_file(str(path), 4096, want, early_stop=s)
              for s in (True, False)]
        fb = [j.resolve_file(str(path), 4096, want, early_stop=s)
              for s in (True, False)]
        assert len(fa[1][0]) == 50
    assert len(fa) == len(fb) > 1
    for x, y in zip(fa, fb):
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("helper", ["sort_kd", "sort_u64_blocks",
                                    "count_u64", "group_by_key"])
def test_native_sort_helpers_match_the_jax_bindings(helper):
    keys = _keys(12, n=50000, distinct=5000)
    docs = np.arange(keys.shape[0], dtype=np.int64)
    if helper == "sort_kd":
        a, b = (keys.copy(), docs.copy()), (keys.copy(), docs.copy())
        assert tbuild.sort_kd_or_none(*a) and jbuild.sort_kd_or_none(*b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        assert not tbuild.sort_kd_or_none(keys.astype(np.int64), docs)
    elif helper == "sort_u64_blocks":
        blocks = [keys[:100], keys[100:30000], keys[30000:]]
        np.testing.assert_array_equal(tbuild.sort_u64_blocks_or_none(blocks),
                                      jbuild.sort_u64_blocks_or_none(blocks))
    elif helper == "count_u64":
        for u, v in zip(tbuild.count_u64_or_none(keys),
                        jbuild.count_u64_or_none(keys)):
            np.testing.assert_array_equal(u, v)
    else:
        uniq = np.unique(keys)
        for u, v in zip(tbuild.group_by_key_or_none(keys, docs, uniq),
                        jbuild.group_by_key_or_none(keys, docs, uniq)):
            np.testing.assert_array_equal(u, v)
        assert tbuild.group_by_key_or_none(keys, docs, uniq[1:]) is None


# --- HostCollectReduceEngine ------------------------------------------------


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
@pytest.mark.parametrize("max_rows", [1 << 28, 7000])
@pytest.mark.parametrize("use_native", [True, False])
def test_host_collect_engine_matches_jax(tmp_path, combine, max_rows,
                                         use_native):
    """Blocks of explicit values and (for sum) implicit ones, fed to both
    engines: the same reduced rows, dtypes, top-k and spill records; a
    ``max_rows`` under the fed rows takes the disk-bucket path."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"x")
    rng = np.random.default_rng(13)
    blocks = []
    for i in range(6):
        k = _keys(20 + i, n=2500, distinct=2000)
        v = (None if combine == "sum" and i % 2 else
             rng.integers(-1000, 1000, 2500).astype(np.int32))
        blocks.append((k, v))
    res = {}
    for pkg, eng_cls, red_cls, out_cls, cfg_cls in (
            ("port", HostCollectReduceEngine, Reducer, MapOutput, JobConfig),
            ("jax", JaxHostEngine, JaxReducer, JaxMapOutput, JaxJobConfig)):
        obs = _obs(pkg)
        eng = eng_cls(cfg_cls(input_path=str(inp), use_native=use_native),
                      red_cls(combine), max_rows=max_rows)
        eng.obs = obs
        for k, v in blocks:
            eng.feed(out_cls(hi=None, lo=None,
                             values=None if v is None else v.copy(),
                             keys64=k.copy()))
        hi, lo, vals, n = eng.finalize()
        top = eng.top_k(7)
        res[pkg] = (hi, lo, vals, n, top, eng.spilled, eng.transport,
                    obs.registry.summary())
    p, j = res["port"], res["jax"]
    for u, v in zip(p[:3] + p[4][:3], j[:3] + j[4][:3]):
        np.testing.assert_array_equal(u, v)
        assert u.dtype == v.dtype
    assert p[3] == j[3] and p[4][3] == j[4][3]
    assert p[5:] == j[5:]
    assert p[5] == (max_rows < 15000)
