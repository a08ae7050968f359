"""Bigram through the port against the JAX package on the CPU: the same
seeded corpus gives a byte-identical ``final_result.txt`` under both
reduces (the host collect and the device fold) with the native and the
Python map, through the hash-only map with its rescan (early stop and
full), the push cadence and every shuffle transport; a lookup miss in the
rescan dictionary raises as in JAX; a killed hash-only job resumes to the
same bytes, and spills cross between the packages in both directions; the
CLIs agree.  The JAX side runs with ``num_shards=1``."""

import numpy as np
import pytest
import torch

import map_oxidize_tpu.runtime.driver as jdriver
import map_oxidize_tpu_torch.runtime.driver as tdriver
from map_oxidize_tpu.cli import main as jax_cli_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.workloads.bigram import make_bigram as jax_make_bigram
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
from map_oxidize_tpu_torch.workloads.bigram import make_bigram

torch.set_num_threads(2)

CHUNK = 24 * 1024


def _corpus(path, seed=0, lines=5000, vocab=700):
    rng = np.random.default_rng(seed)
    words = [b"b%dW" % i for i in range(vocab)]
    z = rng.zipf(1.25, size=(lines, 9)) % vocab
    path.write_bytes(b"\n".join(b" ".join(words[j] for j in row)
                                for row in z) + b"\n")
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("bigram") / "c.txt")


def _both(tmp, corpus, name="r", **kw):
    """Run bigram through both packages; returns the two results and the
    two output paths."""
    out = {}
    for pkg, cfg_cls, run in (("port", JobConfig, run_job),
                              ("jax", JaxJobConfig, jax_run_job)):
        extra = {"num_shards": 1} if pkg == "jax" else {}
        path = tmp / f"{name}_{pkg}.txt"
        r = run(cfg_cls(input_path=str(corpus), output_path=str(path),
                        backend="cpu", chunk_bytes=CHUNK, metrics=False,
                        num_map_workers=2, **extra, **kw), "bigram")
        out[pkg] = (r, path)
    return out


@pytest.mark.parametrize("reduce_mode", ["auto", "collect", "fold"])
@pytest.mark.parametrize("mapper", ["native", "python"])
def test_final_result_is_byte_identical_to_jax(tmp_path, corpus,
                                               reduce_mode, mapper):
    out = _both(tmp_path, corpus, reduce_mode=reduce_mode, mapper=mapper,
                key_capacity=1 << 17)
    (pr, pp), (jr, jp) = out["port"], out["jax"]
    assert pp.read_bytes() == jp.read_bytes()
    assert pr.top == jr.top
    for k in ("records_in", "distinct_keys", "chunks", "device_rows_fed"):
        assert pr.metrics[k] == jr.metrics[k]
    assert pr.metrics["distinct_keys"] > 10_000
    collect = reduce_mode != "fold"
    assert pr.metrics["accumulator_device"] == ("host" if collect
                                                else "cpu")
    assert ("shuffle/transport" in pr.metrics) == collect
    assert pr.metrics.get("shuffle/transport") == jr.metrics.get(
        "shuffle/transport")


@pytest.mark.parametrize("rescan_full", [False, True])
def test_hash_only_map_with_the_rescan_gives_the_same_bytes(
        tmp_path, corpus, rescan_full):
    """The collect route with the native map runs hash-only (no key
    strings in the map; winners and the file resolve by rescanning the
    corpus with the same cuts), with and without the early stop."""
    want = _both(tmp_path, corpus, "fold", reduce_mode="fold",
                 key_capacity=1 << 17)["jax"][1].read_bytes()
    mappers = {}
    for pkg, make, cfg_cls, run in (
            ("port", make_bigram, JobConfig, run_wordcount_job),
            ("jax", jax_make_bigram, JaxJobConfig,
             jdriver.run_wordcount_job)):
        extra = {"num_shards": 1} if pkg == "jax" else {}
        mapper, reducer = make("ascii", True)
        path = tmp_path / f"{pkg}.txt"
        r = run(cfg_cls(input_path=str(corpus), output_path=str(path),
                        backend="cpu", chunk_bytes=CHUNK, metrics=False,
                        rescan_full=rescan_full, **extra),
                mapper, reducer, workload="bigram")
        assert mapper.hash_only
        assert path.read_bytes() == want
        mappers[pkg] = (mapper, r)
    assert mappers["port"][1].top == mappers["jax"][1].top


def test_a_rescan_lookup_miss_raises_as_in_jax(tmp_path, corpus):
    for make in (make_bigram, jax_make_bigram):
        mapper, _ = make("ascii", True)
        d = mapper.rescan_dictionary(str(corpus), CHUNK, early_stop=True)
        with pytest.raises(KeyError):
            d.lookup(12345)
        mapper_keys = mapper._native.map_chunk_hashes(
            corpus.read_bytes()[:2000]).keys64
        h = int(mapper_keys[0])
        assert b" " in d.lookup(h)


@pytest.mark.parametrize("transport", ["hbm", "disk", "hybrid",
                                       "pipelined", "remote"])
def test_every_shuffle_transport_gives_the_same_bytes(tmp_path, corpus,
                                                      transport):
    kw = dict(shuffle_transport=transport)
    if transport in ("hybrid", "pipelined"):
        kw["collect_max_rows"] = 20_000  # demotes mid-job
    out = _both(tmp_path, corpus, **kw)
    (pr, pp), (jr, jp) = out["port"], out["jax"]
    assert pp.read_bytes() == jp.read_bytes()
    keys = ("shuffle/transport", "demote/events", "demote/rows",
            "spill/rows", "spill/bytes", "spill/buckets",
            "spill/begin_events", "shuffle/push_combined_in",
            "shuffle/push_combined_out", "shuffle/push_bytes_saved",
            "pipeline/depth")
    assert ({k: pr.metrics.get(k) for k in keys}
            == {k: jr.metrics.get(k) for k in keys})
    assert pr.metrics["shuffle/transport"] == transport
    assert ("demote/events" in pr.metrics) == (transport in ("hybrid",
                                                             "pipelined"))
    if transport == "pipelined":
        assert pr.metrics["shuffle/push_combined_out"] < pr.metrics[
            "shuffle/push_combined_in"]
        assert "pipeline/shuffle_overlap_ratio" in pr.metrics


def test_hbm_raises_at_the_cap_as_in_jax(tmp_path, corpus):
    for cfg_cls, run, extra in ((JobConfig, run_job, {}),
                                (JaxJobConfig, jax_run_job,
                                 {"num_shards": 1})):
        with pytest.raises(RuntimeError, match="--shuffle-transport hbm"):
            run(cfg_cls(input_path=str(corpus), output_path="",
                        backend="cpu", chunk_bytes=CHUNK, metrics=False,
                        shuffle_transport="hbm", collect_max_rows=1000,
                        **extra), "bigram")


@pytest.mark.parametrize("combine", ["on", "off"])
def test_push_combine_on_the_fold_gives_the_same_bytes(tmp_path, corpus,
                                                       combine):
    out = _both(tmp_path, corpus, reduce_mode="fold", push_combine=combine,
                key_capacity=1 << 17)
    (pr, pp), (jr, jp) = out["port"], out["jax"]
    assert pp.read_bytes() == jp.read_bytes()
    assert pr.metrics.get("shuffle/push_combined_in") == jr.metrics.get(
        "shuffle/push_combined_in")
    assert ("shuffle/push_combined_in" in pr.metrics) == (combine == "on")


# --- kill and resume ----------------------------------------------------------


def _dying_pipelined(module, monkeypatch, die_after):
    """Patch the driver's ``pipelined`` so the map stream raises after
    ``die_after`` chunks: the mid-run kill, with that many chunks spilled."""
    real = module.pipelined

    def dying(it, *a, **kw):
        def gen():
            for i, item in enumerate(it):
                if i == die_after:
                    raise KeyboardInterrupt("simulated kill")
                yield item
        return real(gen(), *a, **kw)

    monkeypatch.setattr(module, "pipelined", dying)


@pytest.mark.parametrize("killer,resumer", [("port", "port"),
                                            ("jax", "port"),
                                            ("port", "jax")])
def test_hash_only_kill_and_resume_across_packages(tmp_path, corpus,
                                                   monkeypatch, killer,
                                                   resumer):
    """A hash-only bigram job killed after 3 chunks resumes — in the same
    package or the other — to the bytes of an uninterrupted run, replaying
    the spilled prefix."""
    pkgs = {"port": (JobConfig, run_job, tdriver, {}),
            "jax": (JaxJobConfig, jax_run_job, jdriver, {"num_shards": 1})}
    ck = tmp_path / "ck"

    def cfg(pkg, out):
        cfg_cls, _, _, extra = pkgs[pkg]
        return cfg_cls(input_path=str(corpus), output_path=str(out),
                       backend="cpu", chunk_bytes=CHUNK, metrics=False,
                       checkpoint_dir=str(ck), **extra)

    want = tmp_path / "want.txt"
    run_job(JobConfig(input_path=str(corpus), output_path=str(want),
                      backend="cpu", chunk_bytes=CHUNK, metrics=False),
            "bigram")
    with monkeypatch.context() as m:
        _dying_pipelined(pkgs[killer][2], m, 3)
        with pytest.raises(KeyboardInterrupt):
            pkgs[killer][1](cfg(killer, tmp_path / "dead.txt"), "bigram")
    assert len(list(ck.glob("chunk_*.npz"))) == 3
    got = tmp_path / "got.txt"
    r = pkgs[resumer][1](cfg(resumer, got), "bigram")
    assert r.metrics["checkpoint/chunks_replayed"] == 3
    assert got.read_bytes() == want.read_bytes()
    assert not ck.exists()


# --- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    [], ["--reduce-mode", "fold"], ["--rescan-full"],
    ["--shuffle-transport", "disk"],
    ["--shuffle-transport", "pipelined", "--push-combine", "off"],
    ["--collect-max-rows", "20000"]])
def test_cli_matches_the_jax_cli(tmp_path, corpus, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    args = ["bigram", str(corpus), "--backend", "cpu", "--chunk-mb", "1",
            "-q"] + flags
    assert cli.main(args + ["--output", "t.txt"]) == 0
    assert jax_cli_main(args + ["--num-shards", "1", "--output",
                                "j.txt"]) == 0
    assert (tmp_path / "t.txt").read_bytes() == (
        tmp_path / "j.txt").read_bytes()
