"""The port's remote-staged transport (``shuffle/remote.py`` and the
``_run_remote_staged`` fold driver) on the CPU.

Two processes stage a word count on a shared filesystem with no process
group at all (every cross-process edge is a manifest), both drain every
partition, and each writes its output partition.  A process SIGKILLed
two chunks into its stage is claimed by the survivor, which re-maps only
the uncommitted chunks and writes output byte-identical to the unharmed
run and to the one-process ``final_result.txt`` (JAX
``tests/test_shuffle_pipelined.py`` :273, :341, :359).  The stage's files
are the JAX package's byte for byte: each package drains a stage the
other wrote.
"""

import json
import os
import sys
import textwrap

import numpy as np

import test_torch_distributed as td

_REMOTE_CHILD = textwrap.dedent("""
    import json, os, signal, sys
    pid, corpus, outdir, die = (int(sys.argv[1]), sys.argv[2],
                                sys.argv[3], int(sys.argv[4]))
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.parallel.distributed import (
        run_distributed_job)
    from map_oxidize_tpu_torch.shuffle import remote as rmod
    if die and pid == 1:
        # a REAL SIGKILL mid-shuffle, after the second committed chunk
        orig = rmod.RemoteStage.append_chunk
        n = [0]
        def bomb(self, *a, **kw):
            orig(self, *a, **kw)
            n[0] += 1
            if n[0] >= 2:
                os.kill(os.getpid(), signal.SIGKILL)
        rmod.RemoteStage.append_chunk = bomb
    cfg = JobConfig(input_path=corpus, backend="cpu",
                    output_path=os.path.join(outdir, "out.txt"),
                    chunk_bytes=512, shuffle_transport="remote",
                    remote_stage_dir=os.path.join(outdir, "stage"),
                    remote_stage_timeout_s=8.0,
                    dist_num_processes=2, dist_process_id=pid)
    r = run_distributed_job(cfg, "wordcount")
    json.dump({"counts": {str(k): v for k, v in r.counts.items()},
               "records": r.records,
               "top": [[w.decode(), c] for _h, w, c in r.top]},
              open(os.path.join(outdir, f"counts{pid}.json"), "w"),
              sort_keys=True)
    print("child", pid, "ok")
""")


def _launch_remote(tmp_path, corpus, sub, die):
    outdir = tmp_path / sub
    outdir.mkdir()
    rcs, logs = td.run_children(
        lambda _port: [[sys.executable, "-c", _REMOTE_CHILD, str(i),
                        str(corpus), str(outdir), str(int(die))]
                       for i in range(2)],
        expect_fail=True)
    return outdir, rcs, logs


def test_remote_staged_2proc_matches_one_process(tmp_path):
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job

    corpus = td.write_corpus(tmp_path / "c.txt", lines=400)
    outdir, codes, logs = _launch_remote(tmp_path, corpus, "clean", False)
    assert codes == [0, 0], "\n".join(logs)
    c0 = json.load(open(outdir / "counts0.json"))
    c1 = json.load(open(outdir / "counts1.json"))
    # the drain is replicated: both processes hold the GLOBAL counts
    assert c0["counts"] == c1["counts"] and c0["top"] == c1["top"]
    run_job(JobConfig(input_path=corpus, backend="cpu", chunk_bytes=512,
                      output_path=str(tmp_path / "one.txt")), "wordcount")
    assert (td.read_parts(str(outdir / "out.txt"), 2)
            == (tmp_path / "one.txt").read_bytes())
    m = json.load(open(outdir / "stage" / "manifest.proc0.json"))
    assert m["schema"] == "moxt-shuffle-stage-v1" and m["final"]


def test_remote_staged_sigkill_recovery(tmp_path):
    """Process 1 is SIGKILLed two chunks into its stage: process 0 claims
    it, re-maps only the uncommitted chunks, drains every partition with
    the manifest checksums intact, and writes output byte-identical to
    an unharmed run."""
    corpus = td.write_corpus(tmp_path / "c.txt", lines=400)
    clean, codes, logs = _launch_remote(tmp_path, corpus, "clean", False)
    assert codes == [0, 0], "\n".join(logs)
    killed, codes, logs = _launch_remote(tmp_path, corpus, "killed", True)
    assert codes[0] == 0, "\n".join(logs)
    assert codes[1] == -9  # genuinely SIGKILLed
    assert (json.load(open(killed / "counts0.json"))["counts"]
            == json.load(open(clean / "counts0.json"))["counts"])
    for part in ("out.txt.part0of2", "out.txt.part1of2"):
        assert (killed / part).read_bytes() == (clean / part).read_bytes()
    assert (killed / "stage" / "claim.proc1").exists()
    rec = json.load(open(killed / "stage" / "manifest.proc1.rec.json"))
    assert rec["final"] and rec["staged_by"] == 0 and rec["proc"] == 1
    dead = json.load(open(killed / "stage" / "manifest.proc1.json"))
    assert not dead["final"] and len(dead["chunks_done"]) == 2
    assert not set(dead["chunks_done"]) & set(rec["chunks_done"])


def _stage(mod, root, n_proc=2, seed=0):
    """Two processes' stages of random rows and strings, written with
    ``mod``'s ``RemoteStage`` (a package's ``shuffle.remote``)."""
    from map_oxidize_tpu_torch.ops.hashing import HashDictionary

    rng = np.random.default_rng(seed)
    for p in range(n_proc):
        st = mod.RemoteStage(root, p, n_proc)
        for c in range(3):
            keys = rng.integers(0, 1 << 63, 50).astype(np.uint64)
            vals = rng.integers(1, 9, 50).astype(np.int64)
            d = HashDictionary()
            for k in keys[:5]:
                d.add(int(k), b"w%d" % int(k % 1000))
            st.stage_strings(d)
            st.append_chunk(c * n_proc + p, keys, vals, records=50)
        st.finish()


def test_a_stage_written_by_each_package_is_read_by_the_other(tmp_path):
    from map_oxidize_tpu.shuffle import remote as jax_remote
    from map_oxidize_tpu_torch.shuffle import remote as port_remote

    roots = {}
    for name, mod in (("jax", jax_remote), ("port", port_remote)):
        roots[name] = str(tmp_path / name)
        _stage(mod, roots[name])
    # the same rows staged by either package: identical files
    for rel in ("manifest.proc0.json", "manifest.proc1.json",
                "proc0/part0.rows", "proc1/part1.rows",
                "proc0/strings.dat"):
        a = open(os.path.join(roots["jax"], rel), "rb").read()
        b = open(os.path.join(roots["port"], rel), "rb").read()
        assert a == b, rel
    for writer, reader in (("jax", port_remote), ("port", jax_remote)):
        root = roots[writer]
        manifests = {p: reader.read_manifest(root, p) for p in range(2)}
        assert all(m["final"] for m in manifests.values())
        for q in range(2):
            k, v, want = reader.read_partition(root, manifests, q)
            other = (jax_remote if reader is port_remote else port_remote)
            k2, v2, want2 = other.read_partition(root, manifests, q)
            np.testing.assert_array_equal(k, k2)
            np.testing.assert_array_equal(v, v2)
            assert want == want2 and k.shape[0] > 0
        assert reader.read_strings(root) == (
            jax_remote.read_strings(root))
    # the takeover claim is exclusive across packages too
    assert port_remote.claim_dead_proc(roots["jax"], 1, 0)
    assert not jax_remote.claim_dead_proc(roots["jax"], 1, 0)
