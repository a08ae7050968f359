"""The ``text-zipf`` configuration and the two word-count cells added with
it (``wordcount.text-zipf.device`` and ``wordcount.hibench-large.native``):
the generator's bytes, its word law against text8's published figures and
against the law's closed form, the cells as the manifest promises them,
and a traced run of each that reads its per-layer metrics."""

from __future__ import annotations

import collections
import hashlib
import json
import types
from pathlib import Path

import pytest

from portbench import calibrate
from portbench.bench import Bench
from portbench.generators import zipf_text
from portbench.run import merged
from portbench.tests.conftest import CHECKOUT

MANIFEST = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
ZIPF = "wordcount.text-zipf.device"
NATIVE = "wordcount.hibench-large.native"
#: text8's published figures (mattmahoney.net/dc/textdata.html)
TEXT8_WORDS, TEXT8_DISTINCT, TEXT8_TOP = 17_005_207, 253_854, 0.0624

#: each new cell at a size a CPU test holds; the Zipf cell's law flattened
#: (q = 3e4) so that a 1 MiB chunk passes the packed window's 2^16 keys
TINY = {
    ZIPF: {"dataset": {"total_bytes": int(2.5 * (1 << 20)), "zipf_q": 3e4,
                       "paragraphs_per_batch": 1024},
           "job_params": {"chunk_bytes": 1 << 20}},
    NATIVE: {"dataset": {"total_bytes": 600_000, "lines_per_batch": 256},
             "job_params": {"chunk_bytes": 1 << 16}},
}


def _spec(**over) -> dict:
    return dict(Bench(CHECKOUT).config("text-zipf")["dataset"], **over)


def _make(spec: dict, seed: int, out: Path) -> tuple[dict, bytes]:
    out.mkdir()
    info = zipf_text.generate(spec, seed, out, "cpu")
    return info, Path(info["path"]).read_bytes()


def test_one_seed_same_bytes_two_seeds_differ(tmp_path):
    spec = _spec(total_bytes=300_000, paragraphs_per_batch=256)
    a, ra = _make(spec, 2**31 + 3, tmp_path / "a")
    _b, rb = _make(spec, 2**31 + 3, tmp_path / "b")
    _c, rc = _make(spec, 2**31 + 4, tmp_path / "c")
    assert hashlib.sha256(ra).digest() == hashlib.sha256(rb).digest()
    assert ra != rc
    assert [p.name for p in (tmp_path / "a").iterdir()] == ["corpus.txt"]
    assert Path(a["path"]).parent == tmp_path / "a"


def test_whole_paragraphs_of_lower_case_words(tmp_path):
    spec = _spec(total_bytes=400_000, paragraphs_per_batch=128)
    info, raw = _make(spec, 5, tmp_path / "t")
    assert len(raw) == info["bytes"] <= spec["total_bytes"]
    assert set(raw) <= set(b"abcdefghijklmnopqrstuvwxyz \n")
    assert raw.endswith(b"\n") and b"  " not in raw
    lines = raw.split(b"\n")[:-1]
    assert len(lines) == info["lines"]
    assert sum(len(line.split(b" ")) for line in lines) == info["words"]
    for line in lines:
        n = len(line.split(b" "))
        assert spec["para_words_min"] <= n <= spec["para_words_max"]
    assert len(raw) > spec["total_bytes"] - max(map(len, lines)) - 1


def test_each_rank_has_its_own_word_longer_with_rank():
    law = zipf_text.Law(_spec())
    ranks = list(range(1, 60_001)) + [10**9 + i for i in range(1000)] + [
        law.max_rank - i for i in range(5)]
    words = law.words(ranks)
    assert len(set(words)) == len(words)
    assert all(w.isalpha() and w.islower() for w in words)
    for r, w in zip(ranks, words):
        assert 26 ** len(w) > r  # never fewer letters than the digits
    mean = [sum(map(len, words[a:b])) / (b - a)
            for a, b in ((0, 100), (10_000, 11_000), (50_000, 60_000),
                         (60_000, 61_000))]
    assert mean == sorted(mean) and mean[-1] > mean[0] + 5


def test_the_fitted_law_matches_text8():
    """In closed form: the text8 count of draws gives its distinct count
    within 2% and rank 1 within 0.2 points; the table of head ranks and
    the tail in closed form move a job's distinct count (1e9 bytes at
    5.88 a word) by less than 1% against a table 4x as long."""
    spec = _spec()
    law = zipf_text.Law(spec)
    assert abs(law.expected_distinct(TEXT8_WORDS) / TEXT8_DISTINCT - 1) < 0.02
    assert abs(law.p_head[0] - TEXT8_TOP) < 0.002
    job = 1e9 / 5.88
    longer = zipf_text.Law(dict(spec, head_ranks=4 * spec["head_ranks"]))
    assert abs(law.expected_distinct(job)
               / longer.expected_distinct(job) - 1) < 0.01
    assert 1.1e6 < law.expected_distinct(job) < 1.35e6


def test_the_draws_follow_the_law(tmp_path):
    """About 1.7M words: the distinct count and rank 1's share within 3%
    of the law's expectation, 5.88 +- 0.1 bytes a word."""
    spec = _spec(total_bytes=10_000_000, paragraphs_per_batch=8192)
    info, raw = _make(spec, 2**31 + 9, tmp_path / "w")
    words = raw.split()
    assert 1.6e6 < len(words) == info["words"] < 1.8e6
    counts = collections.Counter(words)
    law = zipf_text.Law(spec)
    assert abs(len(counts) / law.expected_distinct(len(words)) - 1) < 0.03
    top = counts.most_common(1)[0]
    assert top[0] == law.words([1])[0]
    assert abs(top[1] / len(words) / law.p_head[0] - 1) < 0.03
    assert abs(len(raw) / len(words) - 5.88) < 0.1


#: the per-layer metrics each new cell reports: the word-count metrics it
#: shares with ``wordcount.hibench-large.device``, and the Zipf cell's own
LAYER = {
    ZIPF: {"wc.map_reduce_ms", "tokenize_compact_roofline",
           "device_idle_pct.wc", "wc.read_ms", "wc.stage_ms",
           "wc.enqueue_ms", "wc.fetch_wait_ms", "wc.dict_ms",
           "wc.envelope_ms", "wcz.overflow_ms", "wcz.readback_ms",
           "wcz.write_ms"},
    NATIVE: {"wc.map_reduce_ms", "device_idle_pct.wc", "wc.envelope_ms"},
}
#: the metrics only a device trace reads (none on the CPU)
TRACE_ONLY = {"tokenize_compact_roofline", "device_idle_pct.wc"}


def test_the_cells_are_what_the_benchmark_promises():
    """The benchmark's four cells, one card each, each pair of config and
    traffic once, every config used."""
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert set(cells) == {"kmeans.sift1m-ivf4096",
                          "wordcount.hibench-large.device", ZIPF, NATIVE}
    assert all(w["chips"] == 1 for w in cells.values())
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    assert pairs >= {("text-zipf", "wordcount.device"),
                     ("hibench-wordcount-large", "wordcount.native")}
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_the_new_cells_are_what_the_benchmark_promises():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert cells[ZIPF]["config"] == "text-zipf"
    assert cells[ZIPF]["traffic"] == "wordcount.device"
    assert cells[NATIVE]["config"] == "hibench-wordcount-large"
    assert cells[NATIVE]["traffic"] == "wordcount.native"
    assert cells[ZIPF]["chips"] == cells[NATIVE]["chips"] == 1
    (wps,) = [m for m in MANIFEST["end_to_end"]
              if m["name"] == "words_per_s"]
    assert {ZIPF, NATIVE} <= set(wps["workloads"])
    bench = Bench(CHECKOUT)
    device, native = bench.mix("wordcount.device"), bench.mix(
        "wordcount.native")
    assert native["job_config"] == {"mapper": "native"}
    assert ({k: v for k, v in native.items()
             if k not in ("about", "job_config")}
            == {k: v for k, v in device.items()
                if k not in ("about", "job_config")})
    for cell in (ZIPF, NATIVE):
        assert {m["name"] for m in bench.per_layer(cell)} == LAYER[cell]
    own = {m["name"] for m in MANIFEST["per_layer"]
           if m["name"].startswith("wcz.")}
    assert own == {"wcz.overflow_ms", "wcz.readback_ms", "wcz.write_ms"}
    assert all(m["workloads"] == [ZIPF] for m in MANIFEST["per_layer"]
               if m["name"] in own)


def test_text_zipf_sizes_are_the_sizes_run():
    cfg = Bench(CHECKOUT).config("text-zipf")
    assert cfg["datasize"] == cfg["dataset"]["total_bytes"] == 1_000_000_000
    assert cfg["reduced"] == ["datasize"] and set(cfg["cut"]) == {"datasize"}
    assert cfg["limits"] == {"words_wrong": 0, "topk_wrong": 0}
    assert cfg["job_params"] == {"top_k": 10, "chunk_bytes": 1 << 25,
                                 "tokenizer": "ascii"}
    assert cfg["text8"] == {"words": TEXT8_WORDS, "distinct": TEXT8_DISTINCT,
                            "top_share": TEXT8_TOP, "bytes_per_word": 5.88}
    assert cfg["assumed"] and len(cfg["source"]) <= 200
    (entry,) = [c for c in MANIFEST["configs"] if c["name"] == "text-zipf"]
    assert entry["source"] == cfg["source"]


def _run(cell: str, capsys, trace: int, seconds: float = 0.3) -> dict:
    from portbench import run

    rc = run.main(["--workload", cell, "--seed", str(2**31 + 17),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  backend="cpu", overrides=TINY[cell])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [ZIPF, NATIVE])
def test_a_traced_run_reads_the_cells_metrics(cell, capsys):
    line = _run(cell, capsys, trace=1)
    assert line["correct"] is True and line["failed"] == 0
    names = LAYER[cell] - TRACE_ONLY
    for name in names:
        assert line["metrics"][name]["unit"] == "ms", name
        assert line["metrics"][name]["value"] > 0, name
    # a CPU capture has no device events, so no idle share or roofline
    assert set(line["metrics"]) == names


@pytest.mark.parametrize("name", ["wcz.overflow_ms", "wcz.readback_ms",
                                  "wcz.write_ms"])
def test_a_port_without_the_counter_gives_nothing(name):
    read = Bench(CHECKOUT).reader("layer_metrics", name)
    run = types.SimpleNamespace(done=[{"metrics": {"chunks": 3}}])
    assert read(run) is None
    assert read(types.SimpleNamespace(done=[])) is None


def test_the_control_is_not_correct():
    """The control's blind cuts split words, so a limit of 0 catches it;
    the program reads 0."""
    rows = {r["run"]: r for r in calibrate.readings(
        ZIPF, [2**31 + 21], control=True, with_faults=False, backend="cpu",
        overrides=merged(TINY[ZIPF], {}))}
    assert rows["program"]["words_wrong"] == rows["program"]["topk_wrong"] == 0
    assert rows["control"]["words_wrong"] > 0
