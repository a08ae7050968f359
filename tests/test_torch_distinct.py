"""Distinct (HyperLogLog) through the port against the JAX package on the
CPU: the registers are equal (``np.array_equal``), the estimate is the same
float and the output file is byte-identical, with the native and the
Python map, the text and the ``.npy`` output, several precisions, and
``mapper='device'`` (which both packages resolve to the native map); a
killed job resumes to the same registers, across the packages in both
directions, and the precision is part of the checkpoint identity; the
CLIs agree.  The JAX side runs with ``num_shards=1``."""

import logging

import numpy as np
import pytest
import torch

import map_oxidize_tpu.runtime.driver as jdriver
import map_oxidize_tpu_torch.runtime.driver as tdriver
from map_oxidize_tpu.cli import main as jax_cli_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import resolve_mapper as jax_resolve_mapper
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.workloads import distinct as jd
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import resolve_mapper, run_job
from map_oxidize_tpu_torch.workloads import distinct as td

torch.set_num_threads(2)

CHUNK = 16 * 1024


def _corpus(path, seed=2, lines=4000, vocab=30000):
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.1, size=(lines, 10)) % vocab
    path.write_bytes(b"\n".join(b" ".join(b"d%dQ" % j for j in row)
                                for row in z) + b"\n")
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("distinct") / "c.txt")


def _both(tmp, corpus, suffix=".txt", **kw):
    res = {}
    for pkg, cfg_cls, run, extra in (("port", JobConfig, run_job, {}),
                                     ("jax", JaxJobConfig, jax_run_job,
                                      {"num_shards": 1})):
        path = tmp / f"{pkg}{suffix}"
        r = run(cfg_cls(input_path=str(corpus), output_path=str(path),
                        backend="cpu", chunk_bytes=CHUNK, metrics=False,
                        num_map_workers=2, **extra, **kw), "distinct")
        res[pkg] = r, path.read_bytes()
    return res


@pytest.mark.parametrize("mapper", ["auto", "native", "python", "device"])
@pytest.mark.parametrize("p", [11, 14, 17])
def test_registers_estimate_and_file_match_jax(tmp_path, corpus, mapper, p):
    res = _both(tmp_path, corpus, mapper=mapper, hll_precision=p)
    (pr, pb), (jr, jb) = res["port"], res["jax"]
    assert np.array_equal(pr.registers, jr.registers)
    assert pr.registers.dtype == jr.registers.dtype
    assert pr.estimate == jr.estimate
    assert pb == jb
    for k in ("records_in", "chunks", "registers_filled"):
        assert pr.metrics[k] == jr.metrics[k]
    assert pr.top_report(10) == jr.top_report(10)
    exact = td.distinct_model([corpus.read_bytes()])
    assert abs(pr.estimate - exact) / exact < 5 * 1.04 / np.sqrt(1 << p)


def test_npy_output_matches_jax(tmp_path, corpus):
    res = _both(tmp_path, corpus, suffix=".npy")
    assert res["port"][1] == res["jax"][1]
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"),
                                  res["port"][0].registers)


def test_device_mapper_resolves_to_native_with_the_jax_log_line(
        caplog, monkeypatch):
    """``mapper='device'`` on distinct (and on any workload with a
    non-ascii tokenizer) runs the native map, as the JAX package's
    ``resolve_mapper`` does; wordcount and bigram with the ascii tokenizer
    resolve to the device mapper, as there."""
    # a CLI run earlier in this process detaches the package loggers from
    # the root logger and raises their level (utils.logging.configure)
    monkeypatch.setattr(logging.getLogger("moxt"), "propagate", True)
    with caplog.at_level(logging.INFO, logger="moxt"):
        assert resolve_mapper(JobConfig(mapper="device"), "distinct") == \
            "native"
        assert resolve_mapper(JobConfig(mapper="device",
                                        tokenizer="unicode"),
                              "wordcount") == "native"
    msgs = [r.getMessage() for r in caplog.records]
    assert "device mapper does not implement 'distinct' yet; using native" \
        in msgs
    assert "device mapper is ascii-only; using native for 'unicode'" in msgs
    for wl in ("wordcount", "bigram"):
        assert resolve_mapper(JobConfig(mapper="device"), wl) == "device"
        assert jax_resolve_mapper(JaxJobConfig(mapper="device"),
                                  wl) == "device"


@pytest.mark.parametrize("p", [11, 16, 18])
def test_hll_functions_match_jax(p):
    rng = np.random.default_rng(p)
    hashes = rng.integers(0, 2**64, size=20000, dtype=np.uint64)
    hashes[:5] = 0
    regs = td.hll_registers(hashes, p)
    np.testing.assert_array_equal(regs, jd.hll_registers(hashes, p))
    assert td.hll_estimate(regs) == jd.hll_estimate(regs)
    assert td.hll_estimate(np.zeros(1 << p, np.int32)) == 0.0
    assert (td.HLL_P_MIN, td.HLL_P_MAX) == (jd.HLL_P_MIN, jd.HLL_P_MAX)


@pytest.mark.parametrize("p", [10, 19])
def test_precision_is_validated_as_in_jax(p):
    with pytest.raises(ValueError, match="hll_precision"):
        JobConfig(hll_precision=p).validate()
    with pytest.raises(ValueError, match="hll_precision"):
        JaxJobConfig(hll_precision=p).validate()


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


@pytest.mark.parametrize("killer,resumer", [("port", "port"),
                                            ("jax", "port"),
                                            ("port", "jax")])
def test_kill_and_resume_across_packages(tmp_path, corpus, monkeypatch,
                                         killer, resumer):
    pkgs = {"port": (JobConfig, run_job, tdriver, {}),
            "jax": (JaxJobConfig, jax_run_job, jdriver, {"num_shards": 1})}
    ck = tmp_path / "ck"

    def cfg(pkg, out, p=14):
        cfg_cls, _, _, extra = pkgs[pkg]
        return cfg_cls(input_path=str(corpus), output_path=str(out),
                       backend="cpu", chunk_bytes=CHUNK, metrics=False,
                       checkpoint_dir=str(ck), hll_precision=p, **extra)

    want = run_job(cfg("port", tmp_path / "want.txt"), "distinct")
    with monkeypatch.context() as m:
        _dying_pipelined(pkgs[killer][2], m, 3)
        with pytest.raises(KeyboardInterrupt):
            pkgs[killer][1](cfg(killer, tmp_path / "dead.txt"), "distinct")
    assert len(list(ck.glob("chunk_*.npz"))) == 3
    got = pkgs[resumer][1](cfg(resumer, tmp_path / "got.txt"), "distinct")
    assert got.metrics["checkpoint/chunks_replayed"] == 3
    assert np.array_equal(got.registers, want.registers)
    assert (tmp_path / "got.txt").read_bytes() == (
        tmp_path / "want.txt").read_bytes()


def test_another_precision_does_not_resume_the_spill(tmp_path, corpus,
                                                     monkeypatch):
    ck = tmp_path / "ck"

    def cfg(p):
        return JobConfig(input_path=str(corpus), output_path="",
                         backend="cpu", chunk_bytes=CHUNK, metrics=False,
                         checkpoint_dir=str(ck), hll_precision=p)

    with monkeypatch.context() as m:
        _dying_pipelined(tdriver, m, 3)
        with pytest.raises(KeyboardInterrupt):
            run_job(cfg(12), "distinct")
    r = run_job(cfg(13), "distinct")
    assert "checkpoint/chunks_replayed" not in r.metrics
    assert np.array_equal(r.registers, run_job(
        JobConfig(input_path=str(corpus), output_path="", backend="cpu",
                  chunk_bytes=CHUNK, metrics=False, hll_precision=13),
        "distinct").registers)


# --- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--hll-precision", "12"],
                                   ["--mapper", "python"],
                                   ["--mapper", "device"]])
def test_cli_matches_the_jax_cli(tmp_path, corpus, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    args = ["distinct", str(corpus), "--backend", "cpu", "--chunk-mb", "1",
            "-q"] + flags
    assert cli.main(args + ["--output", "t.txt"]) == 0
    assert jax_cli_main(args + ["--num-shards", "1", "--output",
                                "j.txt"]) == 0
    assert (tmp_path / "t.txt").read_bytes() == (
        tmp_path / "j.txt").read_bytes()
