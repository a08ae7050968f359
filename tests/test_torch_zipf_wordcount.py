"""Word count over Zipf text with more distinct words in a chunk than the
device map's packed window carries (on the CPU): the device and the native
mapper against the benchmark's plain reference, and the counters and spans
of the device map's overflow fetch, its keys, its finalize, its native
write and the accumulator's growth; the benchmark's ``altered_answer``
fault still reaches the device map's writer.

The corpus is the benchmark's ``zipf_text`` generator at the ``text-zipf``
configuration with the law flattened (``q`` = 3e4), so that each whole
1 MiB chunk holds some 84k distinct words, past the 2^16 rows of the
packed window."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.io.splitter import iter_chunks_capped
from map_oxidize_tpu_torch.runtime import run_job
from portbench import faults
from portbench.generators import zipf_text
from portbench.reference import wordcount as reference

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 1 << 20
WINDOW = 1 << 16  # the packed row's dictionary rows (fetch_keys)


def _spans(trace, name):
    return [e for e in trace if e.get("ph") == "X" and e["name"] == name]


@pytest.fixture(scope="module")
def zipf_path(tmp_path_factory):
    """The corpus."""
    tmp = tmp_path_factory.mktemp("zipf")
    spec = json.loads((ROOT / "portbench/configs/text-zipf.json")
                      .read_text())["dataset"]
    spec = dict(spec, zipf_q=3e4, total_bytes=int(2.5 * CHUNK),
                paragraphs_per_batch=1024)
    return zipf_text.generate(spec, 2**31 + 7, tmp, "cpu")["path"]


@pytest.fixture(scope="module")
def zipf(zipf_path, tmp_path_factory):
    """Each chunk's distinct words as the device map cuts them, the
    reference's counts, and one traced job of each mapper."""
    tmp = tmp_path_factory.mktemp("zipf_runs")
    path = zipf_path
    per_chunk = [len(set(bytes(c).split()))
                 for c in iter_chunks_capped(path, CHUNK)]
    ref = reference.counts(path, "cpu")
    runs = {}
    for mapper in ("device", "native"):
        out = tmp / f"{mapper}.txt"
        res = run_job(JobConfig(input_path=path, backend="cpu",
                                mapper=mapper, chunk_bytes=CHUNK,
                                output_path=str(out), metrics=False,
                                trace_out="-"), "wordcount")
        runs[mapper] = (res, out)
    return per_chunk, ref, runs


def test_the_corpus_passes_the_packed_window(zipf):
    per_chunk, _ref, _runs = zipf
    assert len(per_chunk) == 3
    assert sum(n > WINDOW for n in per_chunk) == 2


@pytest.mark.parametrize("mapper", ["device", "native"])
def test_counts_equal_the_reference(zipf, mapper):
    _per, ref, runs = zipf
    res, out = runs[mapper]
    assert reference.read_counts(out) == ref
    assert res.metrics["distinct_keys"] == len(ref)
    assert res.metrics["records_in"] == sum(ref.values())


@pytest.mark.parametrize("mapper", ["device", "native"])
def test_top_k_equals_the_reference(zipf, mapper):
    _per, ref, runs = zipf
    res, _out = runs[mapper]
    assert [(w, int(c)) for w, c in res.top] == reference.top_k(ref, 10)


@pytest.mark.parametrize("mapper", ["device", "native"])
def test_one_row_written_per_distinct_word(zipf, mapper):
    _per, ref, runs = zipf
    res, out = runs[mapper]
    rows = out.read_bytes().splitlines()
    assert len(rows) == res.metrics["distinct_keys"] == len(ref)
    assert rows == sorted(rows)


def test_the_device_maps_file_is_the_native_mappers_and_the_references(
        zipf):
    """The device map's rows, written in one native call, are byte for
    byte the native mapper's file (written by the Python writer) and the
    plain reference's rows."""
    _per, ref, runs = zipf
    device = runs["device"][1].read_bytes()
    assert device == runs["native"][1].read_bytes()
    assert device == b"".join(w + b" %d\n" % ref[w] for w in sorted(ref))


def test_the_native_writer_wrote_every_row_in_the_write_phase(zipf):
    """``device_map/write_rows`` is the job's distinct keys; the native
    call's span lies in the write phase, and no materialization of the
    dictionary runs there (or anywhere in the job); the host map's job
    has no such counter."""
    res = zipf[2]["device"][0]
    m = res.metrics
    assert m["device_map/write_rows"] == m["distinct_keys"] > WINDOW
    (phase,) = _spans(res.trace, "phase/write")
    (span,) = _spans(res.trace, "device_map/write")
    assert span["args"]["rows"] == m["distinct_keys"]
    assert phase["ts"] <= span["ts"]
    assert span["ts"] + span["dur"] <= phase["ts"] + phase["dur"] + 1e-3
    assert m["device_map/write_ms"] == pytest.approx(
        span["dur"] / 1e3, rel=1e-3, abs=1e-3)
    assert _spans(res.trace, "device_map/materialize") == []
    assert m["device_map/materialize_ms"] == 0
    assert "device_map/write_rows" not in zipf[2]["native"][0].metrics


def test_the_altered_answer_fault_still_bites_the_device_map(
        zipf, zipf_path, tmp_path):
    """The benchmark's ``altered_answer`` fault, planted around a device-
    map job, changes exactly one row's count of the unplanted file: the
    fault still reaches the writer that the device map calls."""
    clean = zipf[2]["device"][1].read_bytes().splitlines()
    out = tmp_path / "planted.txt"
    with faults.planted("altered_answer", "wordcount"):
        res = run_job(JobConfig(input_path=zipf_path, backend="cpu",
                                mapper="device", chunk_bytes=CHUNK,
                                output_path=str(out), metrics=False),
                      "wordcount")
    planted = out.read_bytes().splitlines()
    assert len(planted) == len(clean)
    diff = [(a, b) for a, b in zip(clean, planted) if a != b]
    assert len(diff) == 1
    (word, count), (word2, count2) = (r.split(b" ") for r in diff[0])
    assert word == word2 and int(count2) == int(count) + 1
    assert res.metrics["device_map/write_rows"] == 0


def test_overflow_fetches_are_the_chunks_past_the_window(zipf):
    """One fetch, one ``device_map/overflow`` span inside the chunk's
    dict span, for each chunk with more unique keys than the window; the
    counter of its time is its spans' total."""
    per_chunk, _ref, runs = zipf
    res, _out = runs["device"]
    m = res.metrics
    over = [i for i, n in enumerate(per_chunk) if n > WINDOW]
    assert m["device_map/overflow_fetches"] == len(over) > 0
    spans = _spans(res.trace, "device_map/overflow")
    assert [e["args"]["seq"] for e in spans] == over
    assert [e["args"]["keys"] for e in spans] == [per_chunk[i] for i in over]
    dicts = {e["args"]["seq"]: e for e in _spans(res.trace, "device_map/dict")}
    for e in spans:
        d = dicts[e["args"]["seq"]]
        assert d["ts"] <= e["ts"] and e["ts"] + e["dur"] <= d["ts"] + d["dur"]
    assert m["device_map/overflow_ms"] == pytest.approx(
        sum(e["dur"] for e in spans) / 1e3, rel=1e-3, abs=1e-3)
    assert 0 < m["device_map/overflow_ms"] < m["device_map/dict_ms"]


def test_chunk_keys_sum_the_chunks_unique_keys(zipf):
    per_chunk, _ref, runs = zipf
    m = runs["device"][0].metrics
    assert m["chunks"] == len(per_chunk)
    assert m["device_map/chunk_keys"] == sum(per_chunk)


def test_new_keys_are_the_distinct_keys(zipf):
    """Each dict span carries its chunk's unique keys and those new to
    the dictionary; the new keys of all chunks are the job's distinct
    keys."""
    per_chunk, ref, runs = zipf
    res = runs["device"][0]
    spans = sorted(_spans(res.trace, "device_map/dict"),
                   key=lambda e: e["args"]["seq"])
    assert [e["args"]["keys"] for e in spans] == per_chunk
    new = [e["args"]["new_keys"] for e in spans]
    assert all(0 < n <= k for n, k in zip(new, per_chunk))
    assert sum(new) == res.metrics["distinct_keys"] == len(ref)


@pytest.mark.parametrize("mapper", ["device", "native"])
def test_the_accumulator_grows_under_a_span(zipf, mapper):
    """Each growth is an ``engine/grow`` span (beside its instant) with
    the old and new row counts; ``engine/grow_ms`` is their total."""
    res, _out = zipf[2][mapper]
    m = res.metrics
    spans = _spans(res.trace, "engine/grow")
    assert m["engine/grows"] == len(spans) > 0
    assert all(e["args"]["new"] > e["args"]["old"] for e in spans)
    instants = [e for e in res.trace
                if e.get("ph") == "i" and e["name"] == "engine/grow"]
    assert len(instants) == len(spans)
    assert m["engine/grow_ms"] == pytest.approx(
        sum(e["dur"] for e in spans) / 1e3, rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("step", ["readback", "top_k"])
def test_the_finalize_steps_have_a_span_and_a_counter(zipf, step):
    res, _out = zipf[2]["device"]
    (span,) = _spans(res.trace, f"device_map/{step}")
    (phase,) = _spans(res.trace, "phase/finalize")
    assert phase["ts"] <= span["ts"]
    assert span["ts"] + span["dur"] <= phase["ts"] + phase["dur"] + 1e-3
    assert res.metrics[f"device_map/{step}_ms"] == pytest.approx(
        span["dur"] / 1e3, rel=1e-3, abs=1e-3)


def test_a_corpus_inside_the_window_fetches_no_overflow(tmp_path):
    """A corpus whose chunks fit the window, untraced: no overflow
    fetch, and the key counters are still there."""
    words = [b"w%dz" % i for i in range(300)]
    rng = np.random.default_rng(3)
    lines = [b" ".join(words[j] for j in rng.integers(0, 300, 20))
             for _ in range(2000)]
    path = tmp_path / "c.txt"
    path.write_bytes(b"\n".join(lines) + b"\n")
    res = run_job(JobConfig(input_path=str(path), backend="cpu",
                            mapper="device", chunk_bytes=1 << 14,
                            output_path="", metrics=False), "wordcount")
    m = res.metrics
    assert m["device_map/overflow_fetches"] == 0
    assert m["device_map/overflow_ms"] == 0
    assert m["distinct_keys"] == 300
    assert m["device_map/chunk_keys"] == sum(
        len(set(bytes(c).split()))
        for c in iter_chunks_capped(str(path), 1 << 14))
