"""The port's native C++ host mapper against the JAX package's: the same
source built twice (two libraries, one process) gives bit-equal map outputs
and the same chunk cuts, and word count through ``run_job`` with
``mapper='auto'`` runs it and writes the JAX package's bytes.  Also the
bounded prefetch pipeline and the map executor the driver runs it under."""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from map_oxidize_tpu.cli import main as jax_cli_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.native import build as jax_build
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.io.splitter import iter_chunks
from map_oxidize_tpu_torch.native import build
from map_oxidize_tpu_torch.runtime import resolve_mapper, run_job
from map_oxidize_tpu_torch.runtime.executor import MapTaskError, run_map_phase
from map_oxidize_tpu_torch.runtime.pipeline import ChunkPrefetcher, pipelined
from map_oxidize_tpu_torch.workloads.wordcount import WordCountMapper
from test_torch_wordcount import CASES, UNICODE, _mixed_corpus

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

MAP_CASES = {
    "mixed_case_punct": (_mixed_corpus(), "ascii"),
    "empty": (b"", "ascii"),
    "unicode": (UNICODE.encode(), "unicode"),
}


@pytest.fixture(scope="module")
def native():
    """Both libraries, built once per module (g++ at first use)."""
    build._load_lib()
    jax_build._load_lib()


def _columns(out):
    h, lens, blob = out.dictionary.to_arrays()
    order = np.argsort(h, kind="stable")
    return (out.hi, out.lo, out.values, out.records_in,
            h[order], np.asarray(lens)[order], bytes(blob))


def _assert_same(got, want):
    g, w = _columns(got), _columns(want)
    for a, b in zip(g[:3], w[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert g[3] == w[3]                       # records_in
    np.testing.assert_array_equal(g[4], w[4])  # dictionary delta hashes
    np.testing.assert_array_equal(g[5], w[5])
    assert got.dictionary.materialized() == want.dictionary.materialized()


def test_native_source_is_the_jax_packages(native):
    """Code and C ABI identical line for line; only comments may differ."""
    def code(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.lstrip().startswith("//")]

    mine = ROOT / "map_oxidize_tpu_torch/native/csrc/moxt_native.cpp"
    theirs = ROOT / "map_oxidize_tpu/native/csrc/moxt_native.cpp"
    assert code(mine) == code(theirs)
    assert Path(build.library_path()).name.startswith("libmoxt_native_port-")
    # two libraries, each with its own handle
    assert build._load_lib()._name != jax_build._load_lib()._name


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_map_chunk_outputs_bit_equal_to_jax(native, tmp_path, case):
    """Per chunk, with the cross-chunk C++ dictionary in both: hi/lo
    planes, counts, records_in and the dictionary delta, bit for bit."""
    data, tok = MAP_CASES[case]
    inp = tmp_path / "c.txt"
    inp.write_bytes(data)
    mine = build.NativeStream(1, tok)
    theirs = jax_build.NativeStream(1, tok)
    chunks = [bytes(c) for c in iter_chunks(str(inp), 1024)] or [b""]
    for chunk in chunks:
        _assert_same(mine.map_chunk(chunk), theirs.map_chunk(chunk))
    mine.close()
    theirs.close()
    one = build.NativeMapper().map_wordcount(data)
    _assert_same(one, jax_build.NativeMapper().map_wordcount(data))


@pytest.mark.parametrize("case", ["mixed_case_punct", "unicode"])
def test_iter_file_offsets_and_outputs_equal_jax(native, tmp_path, case):
    """The C cuts at chunk_bytes=4096: the same next_offset sequence (the
    resume contract), from offset 0 and from a mid-file cut."""
    data, tok = MAP_CASES[case]
    inp = tmp_path / "c.txt"
    inp.write_bytes(data * 3)
    runs = []
    for mod in (build, jax_build):
        s = mod.NativeStream(1, tok)
        runs.append(list(s.iter_file(str(inp), 4096)))
    offsets = [off for _, off in runs[0]]
    assert offsets == [off for _, off in runs[1]]
    assert len(offsets) > 3 and offsets[-1] == len(data) * 3
    for (a, _), (b, _) in zip(*runs):
        _assert_same(a, b)
    mid = offsets[1]
    resumed = [off for _, off in build.NativeStream(1, tok).iter_file(
        str(inp), 4096, mid)]
    assert resumed == offsets[2:]


def _both(tmp_path, data, **kw):
    inp = tmp_path / "corpus.txt"
    inp.write_bytes(data)
    out_t, out_j = tmp_path / "t.txt", tmp_path / "j.txt"
    common = dict(input_path=str(inp), metrics=False, **kw)
    cfg = JobConfig(output_path=str(out_t), backend="cpu", **common)
    assert resolve_mapper(cfg, "wordcount") == "native"
    r = run_job(cfg)
    j = jax_run_job(JaxJobConfig(output_path=str(out_j), backend="cpu",
                                 num_shards=1, mapper="native", **common))
    return r, j, out_t.read_bytes(), out_j.read_bytes()


RUN_CASES = {**CASES, "round_robin_8": (_mixed_corpus(38), {"num_chunks": 8})}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_auto_runs_native_and_matches_jax_native(native, tmp_path, case):
    data, kw = RUN_CASES[case]
    r, j, got, want = _both(tmp_path, data, **kw)
    assert got == want
    assert r.top == j.top
    assert r.metrics["records_in"] == len(
        data.decode().split() if kw.get("tokenizer") else data.split())
    if case == "round_robin_8":
        assert r.metrics["chunks"] == 8
    mapper = WordCountMapper(kw.get("tokenizer", "ascii"))
    assert mapper._native is not None  # the default mapper is the C++ one


def test_cli_default_is_native_and_matches_jax_cli(native, tmp_path,
                                                   monkeypatch):
    """``python -m map_oxidize_tpu_torch wordcount CORPUS --backend cpu``
    against ``python -m map_oxidize_tpu wordcount CORPUS --backend cpu
    --num-shards 1``: byte-identical ``final_result.txt``."""
    inp = tmp_path / "corpus.txt"
    inp.write_bytes(_mixed_corpus(39, vocab=900, lines=2000))
    made = []
    real = WordCountMapper.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(WordCountMapper, "__init__", spy)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["wordcount", str(inp), "--backend", "cpu",
                     "--output", "t.txt", "-q"]) == 0
    assert len(made) == 1 and made[0]._native is not None
    assert jax_cli_main(["wordcount", str(inp), "--backend", "cpu",
                         "--num-shards", "1", "--output", "j.txt",
                         "-q"]) == 0
    assert (tmp_path / "t.txt").read_bytes() == (
        tmp_path / "j.txt").read_bytes()


def test_python_mapper_and_depths_give_the_native_bytes(native, tmp_path):
    """mapper='python' through the worker pool and a serial pipeline, and
    the native path at depths 1 and 4: the same bytes."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(_mixed_corpus(40, vocab=700, lines=1500))
    outs = []
    for i, kw in enumerate([dict(), dict(pipeline_depth=1),
                            dict(pipeline_depth=4),
                            dict(mapper="python", num_map_workers=3),
                            dict(mapper="python", num_map_workers=1,
                                 pipeline_depth=1)]):
        out = tmp_path / f"o{i}.txt"
        r = run_job(JobConfig(input_path=str(inp), output_path=str(out),
                              backend="cpu", chunk_bytes=2048, metrics=False,
                              **kw))
        assert r.metrics["chunks"] > 5
        outs.append(out.read_bytes())
    assert all(o == outs[0] for o in outs)


def test_map_errors_match_the_python_map(native):
    bad = b"ok \xff\xfe bad\n"
    with pytest.raises(UnicodeDecodeError):
        build.NativeStream(1, "unicode").map_chunk(bad)
    with pytest.raises(UnicodeDecodeError):
        WordCountMapper("unicode", use_native=False).map_chunk(bad)
    with pytest.raises(ValueError, match="tokenizer"):
        build.NativeStream(1, "klingon")


# --- the pipeline and the executor -----------------------------------------

def test_prefetch_keeps_order_and_reraises_after_the_items():
    def gen():
        for i in range(20):
            yield i
        raise KeyboardInterrupt("killed")

    pf = ChunkPrefetcher(gen(), depth=3)
    got = []
    with pytest.raises(KeyboardInterrupt, match="killed"):
        for x in pf:
            got.append(x)
    assert got == list(range(20))
    assert list(pipelined(iter(range(7)), 4)) == list(range(7))
    serial = iter(range(3))
    assert pipelined(serial, 1) is serial  # depth 1: no thread
    with pytest.raises(ValueError, match="depth"):
        ChunkPrefetcher(range(3), 0)


def test_prefetch_bounds_the_queue_and_stops_when_abandoned():
    made = []

    def gen():
        for i in range(1000):
            made.append(i)
            yield i

    pf = ChunkPrefetcher(gen(), depth=2)
    it = iter(pf)
    assert next(it) == 0
    time.sleep(0.2)
    assert len(made) <= 4   # one held, two queued, one blocked in put
    it.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


class _Flaky(WordCountMapper):
    def __init__(self, fails: int):
        super().__init__(use_native=False)
        self.fails = fails
        self.lock = threading.Lock()

    def map_chunk(self, chunk):
        with self.lock:
            self.fails -= 1
            fail = self.fails >= 0
        if fail:
            raise OSError("transient")
        return super().map_chunk(chunk)


@pytest.mark.parametrize("workers", [1, 4])
def test_map_phase_retries_then_gives_up(workers):
    chunks = [b"a b\n", b"c a\n", b"b b\n"]
    got = dict(run_map_phase(chunks, _Flaky(2), workers, max_retries=2,
                             pipeline_depth=2))
    assert sorted(got) == [0, 1, 2]
    assert sum(o.records_in for o in got.values()) == 6
    with pytest.raises(MapTaskError, match="3 attempts"):
        list(run_map_phase(chunks[:1], _Flaky(10), workers, max_retries=2))


def test_native_build_lands_in_the_ports_build_dir(native):
    path = Path(build.library_path())
    assert path.parent == ROOT / "map_oxidize_tpu_torch" / "_build"
    assert path.is_file()
    assert re.fullmatch(r"libmoxt_native_port-[0-9a-f]{16}\.so", path.name)


def test_a_library_built_for_another_cpu_is_never_loaded(native, monkeypatch,
                                                        tmp_path):
    """The name digests what -march=native resolves to on this host: another
    CPU's target names another file, so the build here is not loaded
    there; a forced build replaces a library already on disk."""
    here = build.library_path()
    assert b"-march=" in build._target()
    monkeypatch.setitem(build._targets, build.CXX,
                        build._target().replace(b"-march=", b"-march=other-"))
    assert build.library_path() != here
    monkeypatch.undo()
    assert build.library_path() == here
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    so = Path(build._compile())
    so.write_bytes(b"not a library")
    assert build._compile() == str(so)          # a current file is reused
    assert Path(build._compile(force=True)).read_bytes()[:4] == b"\x7fELF"


def test_the_cpp_source_ships_as_package_data():
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    pattern = data["map_oxidize_tpu_torch.native"]
    assert pattern == ["csrc/*.cpp"]
    pkg = ROOT / "map_oxidize_tpu_torch" / "native"
    assert [p.name for p in pkg.glob(pattern[0])] == ["moxt_native.cpp"]
