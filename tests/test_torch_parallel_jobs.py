"""The port's sharded workloads against the JAX package's at the same shard
count: word count (native and device map), bigram, the inverted index (with
a forced demotion), distinct, sort, join and sessionize on 2, 3 and 8
slots.  The port runs on S CPU slots (a virtual pool over the one CPU
device), the JAX package on its 8 forced CPU devices.  Each output is
byte-identical to the JAX package's at the same S and to the port's own
one-shard run, and the two jobs report the same metric keys (the
``shuffle/*``, ``comms/*`` and launch-ledger keys of the sharded
programs among them) apart from the port's own, with an empty
allowlist.  The CLI with ``--num-shards 8 --exchange-collective
all_gather`` prints the JAX CLI's bytes."""

import json

import numpy as np
import pytest
import torch

from map_oxidize_tpu.cli import main as jax_cli_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job

torch.set_num_threads(2)

#: keys only the port emits (tests/test_torch_obs.py ``PORT_OWN``)
PORT_OWN = {"accumulator_device", "device", "obs/envelope_ms"}


def _corpus(seed=0, vocab=300, lines=1500):
    rng = np.random.default_rng(seed)
    words = [b"w%dx" % i for i in range(vocab)]
    z = rng.zipf(1.3, size=(lines, 10)) % vocab
    return b"\n".join(b" ".join(words[j] for j in row) for row in z) + b"\n"


def _records(seed=2, n=5000, keys=600):
    rng = np.random.default_rng(seed)
    recs = np.stack([rng.integers(0, keys, n, dtype=np.uint64),
                     rng.integers(0, 1 << 63, n, dtype=np.uint64)], axis=1)
    recs[:40, 0] = recs[0, 0]  # a duplicate-heavy key: payload order
    return recs


def _fresh_ledgers():
    """Both packages' launch ledgers, jit caches and dispatch memos as in a
    fresh process, so a job's compiles are its own."""
    import jax

    from map_oxidize_tpu.obs.compile import LEDGER as JAX_LEDGER
    from map_oxidize_tpu.runtime import dispatch as jax_dispatch
    from map_oxidize_tpu_torch.obs.compile import LEDGER
    from map_oxidize_tpu_torch.runtime import dispatch

    jax.clear_caches()
    JAX_LEDGER.programs.clear()
    LEDGER.reset()
    jax_dispatch._auto_cache.clear()
    dispatch._auto_cache.clear()


WC = dict(chunk_bytes=8192, batch_size=2048)
JOBS = {
    "wordcount": ("wordcount", dict(WC, mapper="native")),
    "wordcount_device": ("wordcount", dict(WC, mapper="device",
                                           device_chunk_keys=2048)),
    "bigram": ("bigram", dict(WC, mapper="native")),
    "invertedindex": ("invertedindex", dict(WC)),
    "invertedindex_demoted": ("invertedindex",
                              dict(WC, collect_max_rows=4000,
                                   shuffle_transport="hybrid")),
    "distinct": ("distinct", dict(WC, hll_precision=11)),
    "sort": ("sort", dict(WC)),
    "sort_demoted": ("sort", dict(WC, collect_max_rows=2000,
                                  shuffle_transport="hybrid")),
    "join": ("join", dict(WC)),
    "sessionize": ("sessionize", dict(WC, session_gap=1 << 60)),
}
TEXT = ("wordcount", "bigram", "invertedindex", "distinct")


def _inputs(tmp, workload, kw):
    if workload in TEXT:
        inp = tmp / "corpus.txt"
        inp.write_bytes(_corpus())
        return inp, kw
    inp = tmp / "recs.npy"
    np.save(inp, _records())
    if workload == "join":
        right = tmp / "right.npy"
        np.save(right, _records(seed=3, n=4000))
        kw = dict(kw, join_input_path=str(right))
    return inp, kw


def _run(tmp, pkg, workload, inp, S, kw):
    cfg_cls, run = ((JobConfig, run_job) if pkg == "port"
                    else (JaxJobConfig, jax_run_job))
    out = tmp / f"{pkg}{S}.out"
    _fresh_ledgers()
    r = run(cfg_cls(input_path=str(inp), output_path=str(out),
                    backend="cpu", metrics=False, num_shards=S, **kw),
            workload)
    return r, out.read_bytes()


@pytest.fixture(scope="module")
def one_shard(tmp_path_factory):
    """The port's one-shard output of every job, computed once."""
    out = {}
    for job, (workload, kw) in JOBS.items():
        tmp = tmp_path_factory.mktemp(f"one_{job}")
        inp, kw = _inputs(tmp, workload, kw)
        out[job] = _run(tmp, "port", workload, inp, 1, kw)[1]
    return out


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("job", list(JOBS))
def test_sharded_job_gives_the_jax_bytes_and_keys(tmp_path, one_shard, job,
                                                  S):
    workload, kw = JOBS[job]
    inp, kw = _inputs(tmp_path, workload, kw)
    port, port_bytes = _run(tmp_path, "port", workload, inp, S, kw)
    jax, jax_bytes = _run(tmp_path, "jax", workload, inp, S, kw)
    assert port_bytes == jax_bytes
    assert port_bytes == one_shard[job]
    pk, jk = set(port.metrics), set(jax.metrics)
    assert pk - jk == PORT_OWN & pk
    assert jk - pk == set()
    m = port.metrics
    # the sharded device map's engine is sized for its one-shard routing
    # (ROADMAP C6), so its exchange payload is the port's own
    device = job == "wordcount_device"
    if job == "distinct" or workload in ("wordcount", "bigram"):
        assert m["shuffle/exchanges"] == jax.metrics["shuffle/exchanges"]
        assert m["shuffle/psum_bytes"] == jax.metrics["shuffle/psum_bytes"]
        if not device:
            assert (m["shuffle/all_to_all_bytes"]
                    == jax.metrics["shuffle/all_to_all_bytes"])
    if job.endswith("demoted"):
        for k in ("demote/events", "demote/rows", "spill/rows"):
            assert m[k] == jax.metrics[k], k
    if job == "wordcount_device":
        assert m["shards"] == S
    if workload == "sort":
        assert m["sort/splitters"] == S - 1
    for k in pk & jk:
        if device and k.endswith("/bytes"):
            continue
        if k.startswith("comms/") or k in ("data/partitions",
                                           "shuffle/exchange_collective",
                                           "kmeans_shards"):
            assert m[k] == jax.metrics[k], k


@pytest.mark.parametrize("method", ["all_to_all", "all_gather"])
def test_the_exchange_method_changes_no_byte(tmp_path, one_shard, method):
    workload, kw = JOBS["invertedindex"]
    inp, kw = _inputs(tmp_path, workload, kw)
    r, got = _run(tmp_path, "port", workload, inp, 8,
                  dict(kw, exchange_collective=method))
    assert got == one_shard["invertedindex"]
    assert r.metrics["shuffle/exchange_collective"] == method
    assert r.metrics[f"comms/{method}/collect/route_append/calls"] >= 1


def test_cli_num_shards_and_all_gather_give_the_jax_cli_s_bytes(
        tmp_path, monkeypatch, capsys):
    """``--num-shards 8 --exchange-collective all_gather`` in both CLIs:
    the same stdout and the same ``final_result.txt``, with the sharded
    engine and the pinned wire program in the metrics document."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(_corpus(lines=400))
    monkeypatch.chdir(tmp_path)
    args = ["wordcount", str(inp), "--backend", "cpu", "--num-shards", "8",
            "--exchange-collective", "all_gather", "--top-k", "7", "-q"]
    outs = {}
    for pkg, main in (("port", cli.main), ("jax", jax_cli_main)):
        _fresh_ledgers()
        capsys.readouterr()
        assert main(args + ["--output", f"{pkg}.txt", "--metrics-out",
                            f"{pkg}.json"]) == 0
        outs[pkg] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())
    doc = json.loads((tmp_path / "port.json").read_text())
    assert doc["gauges"]["shuffle/exchange_collective"] == "all_gather"
    assert doc["gauges"]["plan/exchange_collective"] == "all_gather"
    assert {r["collective"] for r in doc["comms"]} == {"all_gather", "psum"}
    jdoc = json.loads((tmp_path / "jax.json").read_text())
    assert ({(r["collective"], r["program"], r["shape"], r["count"],
              r["bytes"]) for r in doc["comms"]}
            == {(r["collective"], r["program"], r["shape"], r["count"],
                 r["bytes"]) for r in jdoc["comms"]})


def test_device_map_keys_route_to_one_shard_and_the_port_completes(
        tmp_path):
    """ROADMAP C6: the device tokenizer's two hash lanes share their low
    three bits (both multipliers are 3 mod 8), so ``bucket_of`` sends every
    device-map key to shard 0 when S divides 8, in both packages.  With a
    chunk holding more distinct words than the JAX package's derived
    bucket cap, its sharded device map raises ``ShuffleOverflowError``;
    the port keeps the routing (its snapshots cross) and sizes the
    engine for it, writing the one-shard bytes."""
    from map_oxidize_tpu.parallel.engine import (
        ShuffleOverflowError as JaxOverflow,
    )
    from map_oxidize_tpu_torch.ops.device_tokenize import (
        pad_chunk,
        tokenize_count_core,
    )
    from map_oxidize_tpu_torch.ops.segment_reduce import (
        keys_from_plane_tensors,
    )
    from map_oxidize_tpu_torch.parallel.shuffle import bucket_of

    words = [b"k%dz" % i for i in range(600)]
    text = b"\n".join(b" ".join(words[i:i + 10])
                      for i in range(0, 600, 10)) + b"\n"
    inp = tmp_path / "c.txt"
    inp.write_bytes(text * 3)
    u_hi, u_lo, _c, _r, packed = tokenize_count_core(
        torch.from_numpy(pad_chunk(text, 8192).copy()), 4097, 2048, 2048)
    nu = int(packed[0])
    keys = keys_from_plane_tensors(u_hi[:nu], u_lo[:nu])
    for S in (2, 4, 8):
        assert set(bucket_of(keys, S).tolist()) == {0}
    kw = dict(input_path=str(inp), backend="cpu", metrics=False,
              num_shards=8, mapper="device", chunk_bytes=8192,
              device_chunk_keys=1024)  # JAX cap: 2 * 128 + 16 < 600
    with pytest.raises(JaxOverflow):
        jax_run_job(JaxJobConfig(output_path="", **kw), "wordcount")
    out = tmp_path / "p.txt"
    run_job(JobConfig(output_path=str(out), **kw), "wordcount")
    one = tmp_path / "one.txt"
    run_job(JobConfig(output_path=str(one), **dict(kw, num_shards=1)),
            "wordcount")
    assert out.read_bytes() == one.read_bytes()


@pytest.mark.parametrize("S", [2, 8])
def test_device_map_takes_a_group_of_disjoint_vocabularies(tmp_path, S):
    """ROADMAP C6, the worst case of the routing: every chunk holds words
    no other chunk holds, so one merge lands S chunks' worth of new keys
    on shard 0.  The first group fills part of the accumulator, the second
    lands more new keys on shard 0 than the JAX engine's derived bucket
    cap plans growth for, the third needs the accumulator grown; the port
    writes the one-shard bytes."""
    sizes = [600] * S + [1000] * 2 * S  # distinct words per chunk, <= 1024
    chunks = []
    for c, n in enumerate(sizes):
        words = b" ".join(b"c%dw%d" % (c, i) for i in range(n))
        chunks.append(words.ljust(8191) + b"\n")
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"".join(chunks))
    kw = dict(input_path=str(inp), backend="cpu", metrics=False,
              mapper="device", chunk_bytes=8192, device_chunk_keys=1024)
    out = tmp_path / "p.txt"
    r = run_job(JobConfig(output_path=str(out), num_shards=S, **kw),
                "wordcount")
    assert r.metrics["chunks"] == 3 * S
    if S == 8:  # the third group grew shard 0's accumulator
        assert r.metrics["engine/grows"] == 1
    one = tmp_path / "one.txt"
    run_job(JobConfig(output_path=str(one), num_shards=1, **kw),
            "wordcount")
    assert out.read_bytes() == one.read_bytes()
    assert len(out.read_bytes().splitlines()) == sum(sizes)


def test_sharded_device_map_snapshot_crosses_between_the_packages(
        tmp_path):
    """An 8-shard device-map snapshot (the sharded engine's state in the
    JAX layout, the union dictionary, the byte offset) written by either
    package resumes in the other, to the same bytes."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(_corpus(lines=3000))
    kw = dict(backend="cpu", metrics=False, num_shards=8, mapper="device",
              chunk_bytes=1024, device_chunk_keys=1024)
    want = None
    for first, second in (("jax", "port"), ("port", "jax")):
        ck = tmp_path / f"ck_{first}"
        runs = {}
        for pkg in (first, second):
            cfg_cls, run = ((JobConfig, run_job) if pkg == "port"
                            else (JaxJobConfig, jax_run_job))
            out = tmp_path / f"{first}_{pkg}.txt"
            r = run(cfg_cls(input_path=str(inp), output_path=str(out),
                            checkpoint_dir=str(ck), keep_intermediates=True,
                            **kw), "wordcount")
            runs[pkg] = (r, out.read_bytes())
        assert runs[first][0].metrics["checkpoint/snapshots_saved"] >= 1
        # the second run resumed: it saved no snapshot before the end
        assert runs[second][1] == runs[first][1]
        assert (runs[second][0].metrics.get("checkpoint/snapshots_saved", 0)
                < runs[first][0].metrics["checkpoint/snapshots_saved"])
        want = want or runs[first][1]
        assert runs[first][1] == want
