"""The port's device mapper (``mapper='device'``) against the JAX package's
on the CPU: word count and bigram write ``final_result.txt`` byte-identical
to the JAX device mapper's and to the port's native mapper's; more chunks
give the same counts; ``out_keys`` is clamped; a snapshot written by
either package resumes in the other; ``run_job`` dispatches like the JAX
package."""

import logging
from collections import Counter

import numpy as np
import pytest
import torch

import map_oxidize_tpu.runtime.device_map as jax_dm
import map_oxidize_tpu_torch.runtime.device_map as port_dm
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import resolve_mapper, run_job
from map_oxidize_tpu_torch.runtime.device_map import run_device_wordcount_job
from map_oxidize_tpu_torch.runtime.engine import CapacityError

torch.set_num_threads(2)

WORDS = ["The", "the", "fox,", "dog", "a", "over", "Lazy", "THE.",
         "multi\tword", "end.", "Zebra", "quux"]


def _corpus(tmp_path, seed=0, lines=300, name="corpus.txt"):
    rng = np.random.default_rng(seed)
    text = "\n".join(" ".join(rng.choice(WORDS, size=11))
                     for _ in range(lines)) + "\n"
    p = tmp_path / name
    p.write_text(text)
    return p, text.encode()


def _cfg(cls, path, out, **kw):
    extra = {"num_shards": 1} if cls is JaxJobConfig else {}
    return cls(input_path=str(path), output_path=str(out), backend="cpu",
               metrics=False, **extra, **kw)


@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
@pytest.mark.parametrize("chunk_bytes", [2048, 1 << 20])
def test_device_map_matches_the_jax_device_mapper(tmp_path, workload,
                                                  chunk_bytes):
    path, _ = _corpus(tmp_path)
    kw = dict(mapper="device", chunk_bytes=chunk_bytes,
              device_chunk_keys=1024, initial_key_capacity=128)
    r = run_job(_cfg(JobConfig, path, tmp_path / "port.txt", **kw), workload)
    j = jax_run_job(_cfg(JaxJobConfig, path, tmp_path / "jax.txt", **kw),
                    workload)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert r.top == j.top
    assert r.metrics["records_in"] == j.metrics["records_in"]
    assert r.metrics["chunks"] == j.metrics["chunks"]
    assert r.metrics["distinct_keys"] == j.metrics["distinct_keys"]
    assert r.metrics["accumulator_device"] == "cpu"


@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
def test_device_map_matches_the_native_mapper(tmp_path, workload):
    """One chunk for bigram: its pairs never straddle chunks, and the device
    mapper cuts chunks at any whitespace where the host mappers cut at a
    newline, so only the chunking decides where they may differ."""
    path, raw = _corpus(tmp_path, lines=400)
    chunk = 2048 if workload == "wordcount" else 1 << 20
    run_job(_cfg(JobConfig, path, tmp_path / "dev.txt", mapper="device",
                 chunk_bytes=chunk, device_chunk_keys=4096), workload)
    run_job(_cfg(JobConfig, path, tmp_path / "nat.txt", mapper="native",
                 chunk_bytes=chunk), workload)
    assert (tmp_path / "dev.txt").read_bytes() == \
        (tmp_path / "nat.txt").read_bytes()
    if workload == "wordcount":
        want = Counter(raw.lower().split())
        assert (tmp_path / "dev.txt").read_bytes() == b"".join(
            w + b" " + str(c).encode() + b"\n" for w, c in sorted(want.items()))


def test_multi_chunk_equals_single_chunk(tmp_path):
    path, _ = _corpus(tmp_path, lines=500)
    small = run_device_wordcount_job(_cfg(
        JobConfig, path, "", chunk_bytes=2048, device_chunk_keys=512,
        initial_key_capacity=128))
    big = run_device_wordcount_job(_cfg(
        JobConfig, path, "", chunk_bytes=1 << 20, device_chunk_keys=4096))
    assert small.metrics["chunks"] > 10 and big.metrics["chunks"] == 1
    assert small.counts == big.counts


def test_out_keys_clamped_to_max_tokens(tmp_path):
    """device_chunk_keys past max_tokens must not desync the packed row's
    slicing from the tokenizer's clamped width."""
    path, raw = _corpus(tmp_path, lines=200)
    r = run_job(_cfg(JobConfig, path, "", mapper="device", chunk_bytes=2048,
                     device_chunk_keys=1 << 16), "wordcount")
    assert r.counts == dict(Counter(raw.lower().split()))


def test_more_uniques_than_the_packed_window_take_the_overflow_fetch(
        tmp_path, monkeypatch):
    """A chunk with more unique keys than ``fetch_keys`` (2^16) fetches the
    rest separately; the counts do not change."""
    rng = np.random.default_rng(3)
    words = [b"u%dq" % i for i in rng.permutation(70_000)]
    path = tmp_path / "u.txt"
    path.write_bytes(b" ".join(words * 2) + b"\n")
    calls = []
    real = port_dm._prefix_packer

    def spy(*a):
        calls.append(a[-1])
        return real(*a)

    monkeypatch.setattr(port_dm, "_prefix_packer", spy)
    r = run_job(_cfg(JobConfig, path, tmp_path / "o.txt", mapper="device",
                     chunk_bytes=1 << 21, device_chunk_keys=1 << 17),
                "wordcount")
    assert calls == [1 << 17]
    assert r.counts == dict(Counter(b" ".join(words * 2).split()))


def test_chunk_key_capacity_raises(tmp_path):
    path = tmp_path / "u.txt"
    path.write_bytes(b" ".join(b"w%d" % i for i in range(500)))
    with pytest.raises(CapacityError, match="device_chunk_keys"):
        run_job(_cfg(JobConfig, path, "", mapper="device",
                     chunk_bytes=1 << 16, device_chunk_keys=64), "wordcount")


def _kill_after(monkeypatch, module, n):
    """Kill the job as it reads its ``n``-th chunk: the port's device map
    reads through ``iter_chunks_into``, the JAX package's through
    ``iter_chunks_capped``."""
    name = ("iter_chunks_into" if module is port_dm
            else "iter_chunks_capped")
    real = getattr(module, name)

    def dying(*a, **k):
        for i, c in enumerate(real(*a, **k)):
            if i == n:
                raise KeyboardInterrupt("simulated kill")
            yield c

    monkeypatch.setattr(module, name, dying)


@pytest.mark.parametrize("first", ["port", "jax"])
@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
def test_snapshot_resumes_across_the_packages(tmp_path, monkeypatch, first,
                                              workload):
    """Killed past its first snapshot (``_SNAP_EVERY`` chunks) in one
    package, resumed in the other: the same bytes as an uninterrupted
    run."""
    path, _ = _corpus(tmp_path, lines=600)
    kw = dict(mapper="device", chunk_bytes=1024, device_chunk_keys=512,
              initial_key_capacity=128)
    run_job(_cfg(JobConfig, path, tmp_path / "fresh.txt", **kw), workload)
    ck = tmp_path / "ck"
    pkgs = {"port": (JobConfig, run_job, port_dm),
            "jax": (JaxJobConfig, jax_run_job, jax_dm)}
    second = "jax" if first == "port" else "port"
    cls, run, mod = pkgs[first]
    kill_at = port_dm._SNAP_EVERY + 3
    with monkeypatch.context() as m:
        _kill_after(m, mod, kill_at)
        with pytest.raises(KeyboardInterrupt):
            run(_cfg(cls, path, tmp_path / "dead.txt",
                     checkpoint_dir=str(ck), **kw), workload)
    assert (ck / "snapshot.npz").is_file()
    cls, run, _ = pkgs[second]
    r = run(_cfg(cls, path, tmp_path / "resumed.txt",
                 checkpoint_dir=str(ck), **kw), workload)
    assert (tmp_path / "resumed.txt").read_bytes() == \
        (tmp_path / "fresh.txt").read_bytes()
    assert r.metrics["chunks"] > kill_at
    assert not ck.exists()


def test_snapshot_cadence_and_counters(tmp_path):
    path, _ = _corpus(tmp_path, lines=600)
    r = run_job(_cfg(JobConfig, path, tmp_path / "o.txt", mapper="device",
                     chunk_bytes=1024, device_chunk_keys=512,
                     checkpoint_dir=str(tmp_path / "ck"),
                     keep_intermediates=True), "wordcount")
    assert r.metrics["checkpoint/snapshots_saved"] == (
        r.metrics["chunks"] // port_dm._SNAP_EVERY)
    assert (tmp_path / "ck" / "snapshot.npz").is_file()


@pytest.mark.parametrize("workload,mapper,tokenizer,want", [
    ("wordcount", "device", "ascii", "device"),
    ("bigram", "device", "ascii", "device"),
    ("wordcount", "device", "unicode", "native"),
    ("bigram", "device", "unicode", "native"),
    ("invertedindex", "device", "ascii", "native"),
    ("distinct", "device", "ascii", "native"),
    ("wordcount", "auto", "ascii", "native"),
])
def test_run_job_dispatch_matches_the_jax_package(tmp_path, caplog,
                                                  monkeypatch, workload,
                                                  mapper, tokenizer, want):
    from map_oxidize_tpu.runtime import resolve_mapper as jax_resolve

    path, _ = _corpus(tmp_path, lines=60)
    kw = dict(mapper=mapper, tokenizer=tokenizer, chunk_bytes=4096,
              device_chunk_keys=1024)
    cfg = _cfg(JobConfig, path, tmp_path / "p.out", **kw)
    # a CLI run earlier in this process detaches the package loggers from
    # the root logger and raises their level (utils.logging.configure)
    monkeypatch.setattr(logging.getLogger("moxt"), "propagate", True)
    with caplog.at_level(logging.INFO, logger="moxt"):
        assert resolve_mapper(cfg, workload) == want
    port_lines = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="moxt"):
        assert jax_resolve(_cfg(JaxJobConfig, path, "", **kw),
                           workload) == want
    assert port_lines == [r.getMessage() for r in caplog.records]
    assert bool(port_lines) == (mapper == "device" and want == "native")
    r = run_job(cfg, workload)
    if want == "device":
        assert "device_rows_fed" not in r.metrics  # the device driver's keys
    elif workload in ("wordcount", "bigram"):
        assert "device_rows_fed" in r.metrics
