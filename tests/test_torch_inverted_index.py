"""The inverted index through the port against the JAX package on the CPU:
the postings file is byte-identical to JAX's and to the oracle
``inverted_index_model`` under the host sort and the device sort (the
torch ``sort_pairs``, on the CPU here), through a forced demotion to disk
buckets, under ``shuffle_transport='disk'`` and with the Python map; the
torch ``sort_pairs`` is bit-equal to the JAX ``_sort_pairs`` on unsigned
top-bit keys and docs and SENTINEL padding; ``CollectEngine`` equals the
JAX engine in both pair orders; a killed job resumes to the same bytes,
across the packages in both directions; the CLIs agree.  The JAX side runs
with ``num_shards=1``."""

import numpy as np
import pytest
import torch

import map_oxidize_tpu.runtime.driver as jdriver
import map_oxidize_tpu_torch.runtime.driver as tdriver
from map_oxidize_tpu.api import MapOutput as JaxMapOutput
from map_oxidize_tpu.cli import main as jax_cli_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.io.writer import write_postings as jax_write_postings
from map_oxidize_tpu.io.writer import (
    write_postings_stream as jax_write_postings_stream,
)
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.collect import CollectEngine as JaxCollect
from map_oxidize_tpu.runtime.collect import _sort_pairs as jax_sort_pairs
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.api import MapOutput
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.io.writer import (
    write_postings,
    write_postings_stream,
)
from map_oxidize_tpu_torch.ops.hashing import SENTINEL
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.collect import CollectEngine, sort_pairs
from map_oxidize_tpu_torch.workloads.inverted_index import (
    inverted_index_model,
)

torch.set_num_threads(2)

CHUNK = 16 * 1024


def _corpus(path, seed=1, lines=4000, vocab=900):
    rng = np.random.default_rng(seed)
    words = [b"t%dZ" % i for i in range(vocab)]
    lens = rng.integers(0, 14, size=lines)
    z = rng.zipf(1.3, size=int(lens.sum())) % vocab
    out, at = [], 0
    for n in lens:  # some empty lines: documents with no terms
        out.append(b" ".join(words[j] for j in z[at:at + n]))
        at += n
    path.write_bytes(b"\n".join(out) + b"\n")
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("ii") / "c.txt")


@pytest.fixture(scope="module")
def model_bytes(corpus, tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "m.txt"
    write_postings(str(path), inverted_index_model(str(corpus)))
    return path.read_bytes()


CASES = {
    "host": dict(collect_sort="host"),
    "auto": dict(),
    "device": dict(collect_sort="device", batch_size=4096),
    "demoted": dict(collect_max_rows=9000),
    "disk": dict(shuffle_transport="disk"),
    "pipelined": dict(shuffle_transport="pipelined"),
    "unicode": dict(tokenizer="unicode"),  # the Python map
    "no_native": dict(use_native=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_postings_are_byte_identical_to_jax_and_the_model(
        tmp_path, corpus, model_bytes, case):
    res = {}
    for pkg, cfg_cls, run, extra in (("port", JobConfig, run_job, {}),
                                     ("jax", JaxJobConfig, jax_run_job,
                                      {"num_shards": 1})):
        path = tmp_path / f"{pkg}.txt"
        r = run(cfg_cls(input_path=str(corpus), output_path=str(path),
                        backend="cpu", chunk_bytes=CHUNK, metrics=False,
                        **extra, **CASES[case]), "invertedindex")
        res[pkg] = r, path.read_bytes()
    (pr, pb), (jr, jb) = res["port"], res["jax"]
    assert pb == jb == model_bytes
    keys = ("records_in", "pairs", "distinct_terms", "chunks",
            "grouped_finalize", "spilled_pairs", "shuffle/transport",
            "demote/events", "demote/rows", "spill/rows", "spill/buckets",
            "data/conservation_checks", "data/conservation_violations")
    assert ({k: pr.metrics.get(k) for k in keys}
            == {k: jr.metrics.get(k) for k in keys})
    assert pr.metrics["pairs"] > 20_000
    assert ("demote/events" in pr.metrics) == (case == "demoted")
    assert ("spilled_pairs" in pr.metrics) == (case in ("demoted", "disk"))
    assert pr.postings.top_by_df(5) == jr.postings.top_by_df(5)
    assert pr.top_report(5) == jr.top_report(5)


def _pair_block(seed, n=6000, pad=700):
    """A ``(4, n)`` uint32 block with top-bit keys and docs, duplicated
    keys, duplicated whole rows and SENTINEL padding."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    b[0, :1500] |= np.uint32(0x80000000)
    b[2, 1000:2500] |= np.uint32(0x80000000)
    b[:2, 2500:3500] = b[:2, 3500:4500]       # duplicate keys
    b[:, 4500:4600] = b[:, 4600:4700]         # duplicate rows
    b[0, 4700:4800] = np.uint32(SENTINEL)     # a real key near the top
    b[:, n - pad:] = np.uint32(SENTINEL)
    return b[:, rng.permutation(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_pairs_is_bit_equal_to_jax(seed):
    b = _pair_block(seed)
    got = sort_pairs(torch.from_numpy(b.view(np.int32))).numpy()
    want = np.asarray(jax_sort_pairs(b))
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("sort_mode", ["host", "device", "spilled"])
@pytest.mark.parametrize("pair_order", ["stable", "lex"])
def test_collect_engine_matches_jax(tmp_path, sort_mode, pair_order):
    """Compact and plane blocks, docs with the top bit set: both engines
    finalize to the same (key, doc) columns — in RAM, on the device, and
    past the cap through the spilled sorted-run drain."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"x")
    rng = np.random.default_rng(3)
    blocks = []
    for i in range(5):
        k = rng.integers(0, 2**64, 3000, dtype=np.uint64)[
            rng.integers(0, 300, 3000)]
        d = rng.integers(-2**62, 2**62, 3000)
        blocks.append((k, d, i % 2 == 0))
    res = {}
    for pkg, eng_cls, out_cls, cfg_cls in (
            ("port", CollectEngine, MapOutput, JobConfig),
            ("jax", JaxCollect, JaxMapOutput, JaxJobConfig)):
        spilled = sort_mode == "spilled"
        eng = eng_cls(cfg_cls(input_path=str(inp), backend="cpu",
                              batch_size=2048,
                              collect_sort="host" if spilled else sort_mode),
                      pair_order=pair_order,
                      **({"max_rows": 7000} if spilled else {}))
        for k, d, compact in blocks:
            out = out_cls(hi=None, lo=None, values=None, keys64=k.copy(),
                          docs64=d.copy())
            if not compact:
                out.ensure_planes()
                out.keys64 = out.docs64 = None
            eng.feed(out)
        if spilled:
            assert eng.spilled
            runs = list(eng.finalize_spilled_runs())
            res[pkg] = tuple(np.concatenate([r[i] for r in runs])
                             for i in range(2))
        else:
            res[pkg] = eng.finalize()
    for g, w in zip(res["port"], res["jax"]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_device_sort_rejects_a_pinned_disk_transport(tmp_path, corpus):
    for cfg_cls, run, extra in ((JobConfig, run_job, {}),
                                (JaxJobConfig, jax_run_job,
                                 {"num_shards": 1})):
        with pytest.raises(ValueError, match="collect_sort"):
            run(cfg_cls(input_path=str(corpus), output_path="",
                        backend="cpu", metrics=False, collect_sort="device",
                        shuffle_transport="disk", **extra), "invertedindex")
        with pytest.raises(RuntimeError, match="device-sort mode"):
            run(cfg_cls(input_path=str(corpus), output_path="",
                        backend="cpu", metrics=False, collect_sort="device",
                        chunk_bytes=CHUNK, collect_max_rows=5000, **extra),
                "invertedindex")


# --- kill and resume ----------------------------------------------------------


def _dying_pipelined(module, monkeypatch, die_after):
    real = module.pipelined

    def dying(it, *a, **kw):
        def gen():
            for i, item in enumerate(it):
                if i == die_after:
                    raise KeyboardInterrupt("simulated kill")
                yield item
        return real(gen(), *a, **kw)

    monkeypatch.setattr(module, "pipelined", dying)


@pytest.mark.parametrize("killer,resumer,sort", [
    ("port", "port", "host"), ("port", "port", "device"),
    ("jax", "port", "host"), ("port", "jax", "host")])
def test_kill_and_resume_across_packages(tmp_path, corpus, model_bytes,
                                         monkeypatch, killer, resumer, sort):
    pkgs = {"port": (JobConfig, run_job, tdriver, {}),
            "jax": (JaxJobConfig, jax_run_job, jdriver, {"num_shards": 1})}
    ck = tmp_path / "ck"

    def cfg(pkg, out):
        cfg_cls, _, _, extra = pkgs[pkg]
        return cfg_cls(input_path=str(corpus), output_path=str(out),
                       backend="cpu", chunk_bytes=CHUNK, metrics=False,
                       checkpoint_dir=str(ck), collect_sort=sort, **extra)

    with monkeypatch.context() as m:
        _dying_pipelined(pkgs[killer][2], m, 3)
        with pytest.raises(KeyboardInterrupt):
            pkgs[killer][1](cfg(killer, tmp_path / "dead.txt"),
                            "invertedindex")
    assert len(list(ck.glob("chunk_*.npz"))) == 3
    got = tmp_path / "got.txt"
    r = pkgs[resumer][1](cfg(resumer, got), "invertedindex")
    assert r.metrics["checkpoint/chunks_replayed"] == 3
    assert r.metrics["data/conservation_violations"] == 0
    assert got.read_bytes() == model_bytes


# --- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    [], ["--collect-sort", "device"], ["--collect-max-rows", "9000"],
    ["--shuffle-transport", "disk"], ["--tokenizer", "unicode"]])
def test_cli_matches_the_jax_cli(tmp_path, corpus, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    args = ["invertedindex", str(corpus), "--backend", "cpu",
            "--chunk-mb", "1", "-q"] + flags
    assert cli.main(args + ["--output", "t.txt"]) == 0
    assert jax_cli_main(args + ["--num-shards", "1", "--output",
                                "j.txt"]) == 0
    assert (tmp_path / "t.txt").read_bytes() == (
        tmp_path / "j.txt").read_bytes()


def test_writers_match_jax(tmp_path):
    post = {b"b": [3, 9], b"a": [1], b"\xc3\xa9": [0, 2, 5]}
    write_postings(str(tmp_path / "t"), post)
    jax_write_postings(str(tmp_path / "j"), post)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    items = [(t, np.array(post[t], np.int64)) for t in sorted(post)]
    got = write_postings_stream(str(tmp_path / "ts"), items)
    want = jax_write_postings_stream(str(tmp_path / "js"), items)
    assert got == want == (3, len((tmp_path / "t").read_bytes()))
    assert (tmp_path / "ts").read_bytes() == (tmp_path / "t").read_bytes()
