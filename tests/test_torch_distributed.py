"""The port's multi-process drivers (``parallel/distributed.py``) on the
CPU: real OS processes under a Gloo process group, each with its S/P local
slots of one S=8 mesh (``--backend cpu``).

Every process maps its chunk subset, the lockstep rounds route keys across
the process boundary, and every process must read back the same result as
the port's one-process run and the JAX package's in-process run at the
same S (8 forced CPU devices): the ``.part<p>of<P>`` files, concatenated
and sorted, are their ``final_result.txt`` byte for byte, the top-k with
its winner strings is equal, and the HLL registers are equal.  The JAX
package's own tests hold its P-process runs to that same in-process run
(``tests/test_distributed.py``).  Also here: the engine's finalized state
against the in-process S=8 engine, the float psum against the one-process
psum (bit-equal), the ``proc_<id>`` spill identity against the JAX
package's, the pipelined push rounds, a resumed and a killed run.

Each child gets a ``communicate`` timeout of at most 240 s and the launch
one retry on a fresh port, so a hang fails its test and never the suite.
The launch helpers serve the other ``test_torch_*distributed*.py`` files.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240

_CHILD = r"""
import json, os, sys, time
spec = json.loads(sys.argv[1]); pid = int(sys.argv[2]); port = sys.argv[3]
nproc = spec["nproc"]
import torch
torch.set_num_threads(2)
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.parallel import distributed as D
if spec.get("log_info"):
    import logging
    from map_oxidize_tpu_torch.utils.logging import configure
    configure(logging.INFO)
slept = [0.0]
slow = spec.get("slow_map_s", 0.0)
if slow and pid == 1:
    # an injected straggler: process 1 sleeps before every chunk it maps
    import map_oxidize_tpu_torch.workloads.wordcount as wc
    _orig = wc.make_wordcount
    def make_slow(*a, **k):
        m, r = _orig(*a, **k)
        om = m.map_chunk
        def slow_map(b):
            time.sleep(slow)
            slept[0] += slow
            return om(b)
        m.map_chunk = slow_map
        return m, r
    wc.make_wordcount = make_slow
die_after = spec.get("die_after_chunks", 0)
if die_after and pid == 1:
    # a deterministic mid-run death: after N checkpoint saves
    from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore
    orig = CheckpointStore.save
    state = {"n": 0}
    def dying_save(self, idx, out, next_offset):
        orig(self, idx, out, next_offset)
        state["n"] += 1
        if state["n"] >= die_after:
            os._exit(3)
    CheckpointStore.save = dying_save
cfg = JobConfig(**spec["config"], backend="cpu",
                dist_coordinator=f"127.0.0.1:{port}",
                dist_num_processes=nproc, dist_process_id=pid)
if spec.get("script"):
    D.init_distributed(cfg.dist_coordinator, nproc, pid)
    exec(spec["script"])
    D.shutdown_distributed()
    sys.exit(0)
if spec.get("kmeans_resume"):
    # interrupted training: 2 iterations snapshot (kept), then the full
    # run resumes the snapshot and runs only the rest
    import dataclasses
    D.run_distributed_job(dataclasses.replace(
        cfg, kmeans_iters=2, keep_intermediates=True), "kmeans")
r = D.run_distributed_job(cfg, spec["workload"])
if isinstance(r, D.DistributedResult):
    payload = {
        "n_keys": r.n_keys, "n_pairs": r.n_pairs, "records": r.records,
        "estimate": r.estimate, "flag_rounds": r.flag_rounds,
        "resumed": r.resumed_chunks,
        "top": [[f"{h:#018x}", None if w is None else w.decode("utf-8"), c]
                for h, w, c in r.top],
        "counts": {str(k): v for k, v in (r.counts or {}).items()},
        "centroids": (None if r.centroids is None
                      else r.centroids.astype("float32").tobytes().hex()),
        "resumed_iters": (r.metrics or {}).get("resumed_iters", 0),
    }
else:
    payload = {k: v for k, v in vars(r).items()
               if isinstance(v, (int, float, str))}
m = r.metrics or {}
payload["slept_s"] = slept[0]
payload["metric_keys"] = sorted(m)
payload["metrics"] = {k: m[k] for k in m
                      if k.startswith(("spill/", "demote/", "shuffle/",
                                       "pipeline/", "kernels/"))}
with open(spec["out"] % pid, "w") as f:
    json.dump(payload, f, sort_keys=True)
D.shutdown_distributed()
print("child", pid, "ok")
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def port_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def run_children(argvs_for_port, timeout=CHILD_TIMEOUT_S,
                 expect_fail=False, env=None):
    """Start one child per argv list (``argvs_for_port(port)``), retried
    once on a fresh port; returns ``(returncodes, logs)``.  A child past
    ``timeout`` is killed (its log says ``(timeout)``)."""
    env = env or port_env()
    for attempt in range(2):
        port = free_port()
        procs = [subprocess.Popen(argv, env=env, cwd=REPO,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for argv in argvs_for_port(port)]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out = "(timeout)"
                p.wait()
            logs.append(out)
        rcs = [p.returncode for p in procs]
        if expect_fail or all(rc == 0 for rc in rcs):
            return rcs, logs
        if attempt == 1 or any("(timeout)" in log for log in logs):
            for i, rc in enumerate(rcs):
                assert rc == 0, f"process {i} failed:\n{logs[i][-4000:]}"
    return rcs, logs


def launch(tmp_path, workload, config, nproc=2, expect_fail=False,
           timeout=CHILD_TIMEOUT_S, tag=None, **spec):
    """Run ``workload`` in ``nproc`` port processes with ``config``
    (JobConfig fields; ``backend='cpu'`` and the dist fields are set
    here); returns the per-process payloads: with ``log_info`` as
    ``(payloads, logs)``, with ``expect_fail`` ``(rcs, logs)`` instead,
    and with a ``script`` (run after the group is up, in place of the job)
    the logs."""
    tag = tag or workload
    out = str(tmp_path / f"res_{tag}_%d.json")
    doc = dict(spec, nproc=nproc, workload=workload, config=config, out=out)
    blob = json.dumps(doc)
    rcs, logs = run_children(
        lambda port: [[sys.executable, "-c", _CHILD, blob, str(i),
                       str(port)] for i in range(nproc)],
        timeout=timeout, expect_fail=expect_fail)
    if expect_fail:
        return rcs, logs
    if spec.get("script"):
        return logs   # the script wrote its own files
    payloads = [json.load(open(out % i)) for i in range(nproc)]
    return (payloads, logs) if spec.get("log_info") else payloads


def write_corpus(path, lines=3000, seed=11):
    rng = np.random.default_rng(seed)
    words = [b"Alpha", b"beta,", b"Gamma.", b"delta", b"eps;", b"zeta"]
    with open(path, "wb") as f:
        for _ in range(lines):
            f.write(b" ".join(words[int(i)]
                              for i in rng.integers(0, 6, 6)) + b"\n")
    return str(path)


def write_wide_corpus(path, n=3000):
    """Most words live in ONE process's chunks: the partition strings
    must resolve through the cross-process miss gather."""
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b"unique%05d shared\n" % i)
    return str(path)


def read_parts(out: str, nproc: int) -> bytes:
    """``<out>.part<p>of<P>`` rows, concatenated and sorted."""
    rows = []
    for p in range(nproc):
        with open(f"{out}.part{p}of{nproc}", "rb") as f:
            rows.extend(f.read().splitlines(keepends=True))
    return b"".join(sorted(rows))


SMALL = dict(chunk_bytes=4096, batch_size=1 << 12, key_capacity=1 << 12,
             top_k=5, num_shards=8)


def port_single(workload, **kw):
    """The port's one-process run at S=8 on the CPU."""
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job

    return run_job(JobConfig(backend="cpu", **kw), workload)


def jax_single(workload, **kw):
    """The JAX package's in-process run at S=8 (8 forced CPU devices)."""
    from map_oxidize_tpu.config import JobConfig as JaxJobConfig
    from map_oxidize_tpu.runtime import run_job as jax_run_job

    return jax_run_job(JaxJobConfig(backend="cpu", metrics=False, **kw),
                       workload)


def _words(payload) -> list:
    """A distributed payload's top-k as ``[word, count]`` rows."""
    return [[w, c] for _h, w, c in payload["top"]]


def _top(result) -> list:
    """A one-process job result's top-k as ``[word, count]`` rows."""
    return [[w.decode("utf-8"), c] for w, c in result.top]


# --- the fold and collect workloads ----------------------------------------


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_wordcount_matches_one_process_and_jax(tmp_path, nproc):
    corpus = write_corpus(tmp_path / "c.txt")
    out = str(tmp_path / "wc.txt")
    cfg = dict(SMALL, input_path=corpus, output_path=out)
    results = launch(tmp_path, "wordcount", cfg, nproc=nproc)
    mine = port_single("wordcount", **dict(cfg, output_path=str(
        tmp_path / "one.txt")))
    ref = jax_single("wordcount", **dict(cfg, output_path=str(
        tmp_path / "jax.txt")))
    # every process holds the SAME replicated result; records are local
    # and sum to the one-process total
    local = [r.pop("records") for r in results]
    assert sum(local) == mine.metrics["records_in"]
    for r in results[1:]:
        assert r["counts"] == results[0]["counts"]
        assert r["top"] == results[0]["top"]
    assert _words(results[0]) == _top(ref) == _top(mine)
    assert results[0]["flag_rounds"] >= 1
    parts = read_parts(out, nproc)
    assert parts == (tmp_path / "one.txt").read_bytes()
    assert parts == (tmp_path / "jax.txt").read_bytes()


def test_push_round_lockstep_consistency_2proc(tmp_path):
    """Under the pipelined transport both processes run the same flag
    rounds, agree on the counts, and match the barrier transport's
    results, with the push evidence live (JAX
    ``tests/test_shuffle_pipelined.py:273``)."""
    corpus = write_corpus(tmp_path / "c.txt", lines=600)
    cfg = dict(SMALL, input_path=corpus, output_path="", chunk_bytes=1024)
    base = launch(tmp_path, "wordcount", dict(cfg, shuffle_transport="hbm"),
                  tag="hbm")
    push = launch(tmp_path, "wordcount", dict(
        cfg, shuffle_transport="pipelined"), tag="push")
    assert push[0]["counts"] == push[1]["counts"] == base[0]["counts"]
    assert push[0]["flag_rounds"] == push[1]["flag_rounds"]
    for doc in push:
        m = doc["metrics"]
        assert m["shuffle/transport"] == "pipelined"
        assert m["shuffle/push_rounds"] >= 1
        assert m["shuffle/push_rows"] >= 1
        # the window combiner collapsed duplicate keys before the push
        assert m["shuffle/push_combined_out"] < m["shuffle/push_combined_in"]
        assert m["pipeline/shuffle_overlap_ratio"] >= 0.0


def test_wide_vocab_partitions_resolve_through_the_gather(tmp_path):
    corpus = write_wide_corpus(tmp_path / "wide.txt")
    out = str(tmp_path / "ww.txt")
    cfg = dict(SMALL, input_path=corpus, output_path=out)
    results = launch(tmp_path, "wordcount", cfg)
    jax_single("wordcount", **dict(cfg, output_path=str(
        tmp_path / "jax.txt")))
    assert results[0]["top"] == results[1]["top"]
    assert read_parts(out, 2) == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("case", ["resident", "spilled", "spilled_disk"])
def test_two_process_invertedindex_parts_byte_identical(tmp_path, case):
    """Resident, demoted past the cap (hybrid) and staged on disk from the
    first round: the parts are the one-process postings byte for byte;
    spilled, the per-process partitions are disjoint, cover every pair,
    and never sat whole in host memory (JAX
    ``tests/test_shuffle_transport.py:319``)."""
    corpus = write_corpus(tmp_path / "ii.txt", lines=1500)
    out = str(tmp_path / "ii.txt.out")
    cfg = dict(SMALL, input_path=corpus, output_path=out)
    if case != "resident":
        # far past the resident cap: per-process disk buckets
        cfg.update(collect_max_rows=1500, shuffle_transport=(
            "hybrid" if case == "spilled" else "disk"))
    results = launch(tmp_path, "invertedindex", cfg)
    metrics = [r["metrics"] for r in results]
    ref = jax_single("invertedindex", **dict(
        SMALL, input_path=corpus, output_path=str(tmp_path / "jax.txt")))
    mine = port_single("invertedindex", **dict(
        SMALL, input_path=corpus, output_path=str(tmp_path / "one.txt")))
    for r in results:
        r.pop("records")
        r.pop("metrics")
    assert results[0]["top"] == results[1]["top"]
    assert results[0]["n_pairs"] == results[1]["n_pairs"]
    # each winner's df is its posting list's length in the JAX run
    for _h, w, c in results[0]["top"]:
        assert len(ref.postings[w.encode()]) == c
    assert results[0]["n_keys"] == len(mine.postings)
    parts = read_parts(out, 2)
    assert parts == (tmp_path / "jax.txt").read_bytes()
    assert parts == (tmp_path / "one.txt").read_bytes()
    if case != "resident":
        spill = [m.get("spill/rows", 0) for m in metrics]
        peaks = [m.get("shuffle/peak_staged_rows", 0) for m in metrics]
        assert all(x > 0 for x in spill)
        assert sum(spill) == results[0]["n_pairs"]
        assert all(0 < p < x for p, x in zip(peaks, spill))
        assert [m.get("demote/events", 0) for m in metrics] == (
            [1, 1] if case == "spilled" else [0, 0])


def test_two_process_distinct_registers_equal(tmp_path):
    corpus = write_corpus(tmp_path / "d.txt", lines=800)
    out = str(tmp_path / "d.npy")
    cfg = dict(SMALL, input_path=corpus, output_path=out)
    results = launch(tmp_path, "distinct", cfg)
    jax_single("distinct", **dict(cfg, output_path=str(tmp_path / "j.npy")))
    port_single("distinct", **dict(cfg, output_path=str(tmp_path / "o.npy")))
    assert results[0]["estimate"] == results[1]["estimate"]
    assert abs(results[0]["estimate"] - 6) < 0.5
    # process 0 writes the replicated registers: the one-process file
    assert open(out, "rb").read() == (tmp_path / "j.npy").read_bytes()
    assert open(out, "rb").read() == (tmp_path / "o.npy").read_bytes()


def test_two_process_checkpoint_resume(tmp_path):
    """Process 1 dies after spilling 2 chunks; the re-run resumes its
    spilled prefix and the result is the one-process result."""
    corpus = write_corpus(tmp_path / "ck.txt")
    ckpt = str(tmp_path / "ckpt")
    cfg = dict(SMALL, input_path=corpus, output_path="",
               checkpoint_dir=ckpt, keep_intermediates=True)
    rcs, logs = launch(tmp_path, "wordcount", cfg, expect_fail=True,
                       die_after_chunks=2, tag="die")
    assert any(rc != 0 for rc in rcs), logs
    assert os.path.isdir(os.path.join(ckpt, "proc_1"))
    results = launch(tmp_path, "wordcount", cfg)
    assert results[1]["resumed"] >= 2
    assert results[0]["counts"] == results[1]["counts"]
    mine = port_single("wordcount", **dict(SMALL, input_path=corpus,
                                           output_path=""))
    assert _words(results[0]) == _top(mine)


def test_process_death_aborts_cleanly(tmp_path):
    """A peer dying mid-run makes the survivor EXIT nonzero, not hang."""
    corpus = write_corpus(tmp_path / "dd.txt")
    cfg = dict(SMALL, input_path=corpus, output_path="",
               checkpoint_dir=str(tmp_path / "ck2"))
    rcs, logs = launch(tmp_path, "wordcount", cfg, expect_fail=True,
                       die_after_chunks=1, tag="death")
    assert rcs[1] != 0
    assert rcs[0] is not None and rcs[0] != 0, logs[0][-2000:]
    assert "(timeout)" not in logs[0]


def test_gather_strings_single_process():
    """The collectives degrade to identity in one process."""
    from map_oxidize_tpu_torch.ops.hashing import HashDictionary, moxt64_bytes
    from map_oxidize_tpu_torch.parallel.distributed import gather_strings

    d = HashDictionary()
    h1, h2 = moxt64_bytes(b"alpha"), moxt64_bytes(b"beta")
    d.add(h1, b"alpha")
    assert gather_strings([h1, h2], d) == {h1: b"alpha"}
    assert gather_strings([], d) == {}


def test_spill_identity_equals_the_jax_package_s(tmp_path):
    """Each process's spill lives under ``<checkpoint_dir>/proc_<id>`` with
    the JAX package's identity (which names P and p), so the JAX
    package's store accepts the port's directory as its own."""
    from map_oxidize_tpu.config import JobConfig as JaxJobConfig
    from map_oxidize_tpu.runtime.checkpoint import (
        CheckpointStore as JaxStore,
    )

    corpus = write_corpus(tmp_path / "c.txt", lines=600)
    ckpt = str(tmp_path / "ck")
    cfg = dict(SMALL, input_path=corpus, output_path="",
               checkpoint_dir=ckpt, keep_intermediates=True)
    launch(tmp_path, "wordcount", cfg)
    jcfg = JaxJobConfig(backend="cpu", metrics=False, **cfg)
    for p in range(2):
        d = os.path.join(ckpt, f"proc_{p}")
        with open(os.path.join(d, "meta.json")) as f:
            mine = json.load(f)
        want = JaxStore.job_meta(jcfg, "wordcount", extra={
            "dist_processes": 2, "dist_process_id": p})
        store = JaxStore(d, want)
        assert store.meta == mine
        assert store.saved_prefix() >= 1   # not discarded as foreign


# --- the engine and the collectives under a process group -----------------


_STATE_SCRIPT = r"""
import numpy as np
from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.parallel.distributed import DistributedReduceEngine
eng = DistributedReduceEngine(cfg, SumReducer())
g = np.load(spec["batches"])
B = eng._eng.feed_batch
for b in range(g["hi"].shape[0] // B):
    sl = slice(b * B + pid * eng.local_rows, b * B + (pid + 1) * eng.local_rows)
    n = int(g["n"][b]) - pid * eng.local_rows
    n = max(0, min(n, eng.local_rows))
    eng.merge_local(g["hi"][sl][:n], g["lo"][sl][:n], g["vals"][sl][:n])
hi, lo, vals, n = eng.finalize()
t_hi, t_lo, t_vals = eng.top_k(7)
np.savez(spec["out"] % pid, hi=hi, lo=lo, vals=vals, n=n, t_hi=t_hi,
         t_lo=t_lo, t_vals=t_vals, cap=eng._eng.capacity)
"""


def test_engine_finalized_state_equals_the_in_process_engine(tmp_path):
    """Two processes x 4 slots fed the rows of the same global batches
    (process p's B/P rows of each) end with the in-process S=8 engine's
    state, bit for bit: keys route by ``bucket_of``, each accumulator
    ends sorted, the sums are integers, and growth reads the global live
    count, so the capacities agree too."""
    import torch

    from map_oxidize_tpu_torch.api import SumReducer
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.ops.segment_reduce import keys_from_planes
    from map_oxidize_tpu_torch.parallel.engine import ShardedReduceEngine
    from map_oxidize_tpu_torch.parallel.mesh import make_mesh

    cfg = dict(num_shards=8, batch_size=1 << 10, key_capacity=1 << 14,
               initial_key_capacity=64, input_path="")
    rng = np.random.default_rng(3)
    B, rounds = 1 << 10, 6
    keys = rng.integers(0, 3000, B * rounds).astype(np.uint64) * \
        np.uint64(0x9E3779B97F4A7C15)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    vals = rng.integers(1, 5, B * rounds).astype(np.int32)
    n = np.array([B, B, B - 100, B, 300, B], np.int64)   # short batches
    for b in range(rounds):   # padding rows past n[b]
        hi[b * B + n[b]:(b + 1) * B] = 0xFFFFFFFF
        lo[b * B + n[b]:(b + 1) * B] = 0xFFFFFFFF
        vals[b * B + n[b]:(b + 1) * B] = 0
    batches = str(tmp_path / "batches.npz")
    np.savez(batches, hi=hi, lo=lo, vals=vals, n=n)
    launch(tmp_path, "wordcount", cfg, script=_STATE_SCRIPT,
           batches=batches, tag="state")

    eng = ShardedReduceEngine(JobConfig(backend="cpu", **cfg), SumReducer(),
                              mesh=make_mesh(8, "cpu"))
    for b in range(rounds):
        sl = slice(b * B, (b + 1) * B)
        # the one-process twin of merge_local: a B-row global batch
        k = torch.from_numpy(keys_from_planes(hi[sl], lo[sl]))
        v = torch.from_numpy(vals[sl])
        eng._feed(eng.mesh.split(k), eng.mesh.split(v), eng.feed_batch)
    w_hi, w_lo, w_vals, w_n = eng._finalize()
    t_k, t_v = eng._top_k_device(7)
    from map_oxidize_tpu_torch.ops.segment_reduce import planes_from_keys

    t_hi, t_lo = planes_from_keys(t_k)
    for p in range(2):
        got = np.load(str(tmp_path / f"res_state_{p}.json") + ".npz")
        assert int(got["cap"]) == eng.capacity
        assert int(got["n"]) == w_n
        np.testing.assert_array_equal(got["hi"], w_hi)
        np.testing.assert_array_equal(got["lo"], w_lo)
        np.testing.assert_array_equal(got["vals"], w_vals)
        np.testing.assert_array_equal(got["t_hi"], t_hi)
        np.testing.assert_array_equal(got["t_lo"], t_lo)
        np.testing.assert_array_equal(got["t_vals"], t_v.numpy())


_PSUM_SCRIPT = r"""
import numpy as np, torch
from map_oxidize_tpu_torch.parallel.mesh import (
    make_mesh, psum, all_gather, all_to_all)
mesh = make_mesh(8, "cpu")
x = np.load(spec["parts"])
mine = [torch.from_numpy(x[mesh.global_index(i)]) for i in range(4)]
s = psum(mesh, mine)
g = all_gather(mesh, mine, tiled=True)
# all_to_all: shard s sends row d = s * 100 + d to shard d
bufs = [torch.arange(8, dtype=torch.int64) + 100 * mesh.global_index(i)
        for i in range(4)]
a = all_to_all(mesh, bufs)
u = [torch.tensor([2**64 - 1 - mesh.global_index(i)], dtype=torch.uint64)
     for i in range(4)]
ug = all_gather(mesh, u, tiled=True)[0]
np.savez(spec["out"] % pid, psum=s[0].numpy(), same=all(
    t.data_ptr() == s[0].data_ptr() for t in s), gather=g[0].numpy(),
    a2a=torch.stack(a).numpy(), ug=ug.view(torch.int64).numpy())
"""


def test_collectives_across_processes_equal_one_process(tmp_path):
    """The float psum over 2 processes x 4 slots is bit-equal to the
    one-process 8-slot psum (a gather, then a sum in global shard order,
    never Gloo's ring all_reduce); all_gather and all_to_all lay rows out
    in global shard order; an unsigned tensor crosses as its bytes."""
    import torch

    from map_oxidize_tpu_torch.parallel.mesh import make_mesh, psum

    rng = np.random.default_rng(9)
    # magnitudes far apart: any other summation order changes the bits
    x = (rng.normal(size=(8, 5, 3)) * 10.0 ** rng.integers(
        -6, 7, size=(8, 1, 1))).astype(np.float32)
    parts = str(tmp_path / "parts.npy")
    np.save(parts, x)
    launch(tmp_path, "wordcount", dict(num_shards=8, input_path=""),
           script=_PSUM_SCRIPT, parts=parts, tag="psum")
    one = psum(make_mesh(8, "cpu"), [torch.from_numpy(p) for p in x])[0]
    ring = x[0] + x[4] + x[1] + x[5] + x[2] + x[6] + x[3] + x[7]
    assert not np.array_equal(ring, one.numpy())   # the order shows
    for p in range(2):
        got = np.load(str(tmp_path / f"res_psum_{p}.json") + ".npz")
        assert got["psum"].tobytes() == one.numpy().tobytes()
        assert bool(got["same"])
        np.testing.assert_array_equal(got["gather"], x.reshape(-1, 3))
        a2a = got["a2a"]   # [local dst, src]
        for j in range(4):
            dst = 4 * p + j
            np.testing.assert_array_equal(
                a2a[j], np.arange(8) * 100 + dst)
        want = np.array([2**64 - 1 - s for s in range(8)], np.uint64)
        np.testing.assert_array_equal(got["ug"].view(np.uint64), want)


def test_config_and_cli_validation_match_the_jax_package():
    """The five fields and flags, their defaults and their refusals."""
    from map_oxidize_tpu.cli import build_parser as jax_parser
    from map_oxidize_tpu.config import JobConfig as JaxJobConfig
    from map_oxidize_tpu_torch.cli import build_parser
    from map_oxidize_tpu_torch.config import JobConfig

    names = ("dist_coordinator", "dist_num_processes", "dist_process_id",
             "remote_stage_dir", "remote_stage_timeout_s")
    mine = {f.name: f.default for f in dataclasses.fields(JobConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxJobConfig)}
    assert {n: mine[n] for n in names} == {n: ref[n] for n in names}
    for bad in (dict(dist_coordinator="h:1", dist_num_processes=1,
                     dist_process_id=0),
                dict(dist_coordinator="h:1", dist_num_processes=2,
                     dist_process_id=2),
                dict(remote_stage_timeout_s=0.0),
                dict(obs_port=65535, dist_num_processes=2)):
        with pytest.raises(ValueError):
            JobConfig(input_path="x", **bad).validate()
        with pytest.raises(ValueError):
            JaxJobConfig(input_path="x", **bad).validate()
    flags = ["--dist-coordinator", "h:5", "--dist-processes", "2",
             "--dist-process-id", "1", "--remote-stage-dir", "st",
             "--remote-stage-timeout", "7.5"]
    a = vars(build_parser().parse_args(["wordcount", "c", *flags]))
    b = vars(jax_parser().parse_args(["wordcount", "c", *flags]))
    for k in ("dist_coordinator", "dist_processes", "dist_process_id",
              "remote_stage_dir", "remote_stage_timeout"):
        assert a[k] == b[k]
