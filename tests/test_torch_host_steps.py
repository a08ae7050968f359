"""The host steps the card waits on, named by the port's own trace (on the
CPU): the device map's five spans per chunk and their ``device_map/*_ms``
counters, the resident k-means transfer split into ``kmeans/read_points``
and ``kmeans/copy_points``, the job envelope (``obs/setup``,
``obs/finish``, ``obs/envelope_ms``), and every span mirrored as a
``torch.profiler`` range of the same name while a capture records."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs.trace import NULL_SPAN, Tracer
from map_oxidize_tpu_torch.runtime import run_job

torch.set_num_threads(2)

STEPS = ("read", "stage", "enqueue", "fetch_wait", "dict")


def _corpus(path, lines=6000, seed=5):
    rng = np.random.default_rng(seed)
    words = [b"w%dq" % i for i in range(700)]
    z = rng.zipf(1.3, size=(lines, 14)) % len(words)
    path.write_bytes(b"\n".join(b" ".join(words[j] for j in row)
                                for row in z) + b"\n")
    return path


def _points(path, n=4000, d=8, k=6, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    np.save(path, (centres[rng.integers(0, k, size=n)]
                   + rng.normal(0, 0.5, size=(n, d))).astype(np.float32))
    return path


def _device_wordcount(tmp_path, **kw):
    corpus = _corpus(tmp_path / "c.txt")
    cfg = JobConfig(input_path=str(corpus), backend="cpu", mapper="device",
                    chunk_bytes=1 << 15, device_chunk_keys=4096,
                    output_path="", metrics=False, **kw)
    return run_job(cfg, "wordcount"), corpus.stat().st_size


def _kmeans(tmp_path, **kw):
    pts = _points(tmp_path / "p.npy")
    cfg = JobConfig(input_path=str(pts), backend="cpu", mapper="device",
                    kmeans_k=6, kmeans_iters=3, output_path="",
                    metrics=False, **kw)
    return run_job(cfg, "kmeans")


def _spans(trace, name):
    return [e for e in trace if e.get("ph") == "X" and e["name"] == name]


@pytest.mark.parametrize("step", STEPS)
def test_device_map_has_each_step_once_per_chunk(tmp_path, step):
    """Each chunk has its five steps on the driver thread, inside the
    phase, with ``seq`` and ``bytes``; the read has one more span, the
    generator's end.  Each counter is its spans' total (the fetch wait's
    is the wait inside its spans)."""
    res, size = _device_wordcount(tmp_path, trace_out="-")
    chunks = res.metrics["chunks"]
    assert chunks >= 10
    spans = _spans(res.trace, f"device_map/{step}")
    seqs = [e["args"]["seq"] for e in spans]
    assert seqs == list(range(chunks + (step == "read")))
    assert sum(e["args"]["bytes"] for e in spans) == size
    (phase,) = _spans(res.trace, "phase/map+reduce")
    for e in spans:
        assert e["tid"] == phase["tid"] == 0
        assert phase["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= phase["ts"] + phase["dur"] + 1e-3
    counter = res.metrics[f"device_map/{step}_ms"]
    total = sum(e["dur"] for e in spans) / 1e3
    if step == "fetch_wait":  # the wait's own clock reads, inside the span
        assert 0 < counter <= total
    else:
        assert counter == pytest.approx(total, rel=1e-3,
                                        abs=1e-3 * len(spans))


def test_device_map_steps_cover_the_phase(tmp_path):
    """The five counters cover at least 90% of ``time/map+reduce_s``, and
    no more than all of it."""
    res, _ = _device_wordcount(tmp_path)
    m = res.metrics
    covered = sum(m[f"device_map/{s}_ms"] for s in STEPS)
    phase_ms = 1e3 * m["time/map+reduce_s"]
    assert 0.9 * phase_ms <= covered <= phase_ms + 0.1


def test_fetch_wait_counter_takes_the_device_waits_clock_reads(
        tmp_path, monkeypatch):
    """``device_map/fetch_wait_ms`` is the sum of the packed fetches'
    waits as ``device/compute_ms`` records them: one interval, timed
    once."""
    from map_oxidize_tpu_torch.runtime import device_map

    waits = []

    def observe(t0):
        waits.append(real(t0))
        return waits[-1]

    real = device_map.observe_device_wait
    monkeypatch.setattr(device_map, "observe_device_wait", observe)
    res, _ = _device_wordcount(tmp_path)
    assert len(waits) == res.metrics["chunks"]
    assert res.metrics["device_map/fetch_wait_ms"] == pytest.approx(
        sum(waits), rel=1e-9)


def test_kmeans_splits_the_transfer_and_names_the_envelope(tmp_path):
    res = _kmeans(tmp_path, trace_out="-")
    m = res.metrics
    names = {e["name"] for e in res.trace}
    assert {"kmeans/read_points", "kmeans/copy_points", "obs/setup",
            "obs/finish"} <= names
    (read,) = _spans(res.trace, "kmeans/read_points")
    (copy,) = _spans(res.trace, "kmeans/copy_points")
    assert read["args"]["bytes"] == copy["args"]["bytes"] == 4000 * 8 * 4
    assert read["ts"] + read["dur"] <= copy["ts"] + 1e-3
    split = m["kmeans/read_points_ms"] + m["kmeans/copy_points_ms"]
    assert split <= 1e3 * m["time/transfer_s"] + 0.1
    (setup,) = _spans(res.trace, "obs/setup")
    (finish,) = _spans(res.trace, "obs/finish")
    (first,) = _spans(res.trace, "phase/iterate")
    assert setup["ts"] == 0.0 and setup["tid"] == first["tid"] == 0
    assert setup["ts"] + setup["dur"] <= first["ts"] + 1e-3
    (write,) = _spans(res.trace, "phase/write")
    assert finish["ts"] >= write["ts"] + write["dur"] - 1e-3
    assert m["obs/envelope_ms"] == pytest.approx(
        (setup["dur"] + finish["dur"]) / 1e3, abs=0.1)


def test_a_trace_dir_job_is_traced(tmp_path):
    """``trace_dir`` alone traces the job (its device trace holds the
    spans as profiler ranges) and writes no ``trace_out`` file."""
    res = _kmeans(tmp_path, trace_dir=str(tmp_path / "prof"))
    assert {"obs/setup", "kmeans/read_points"} <= {e["name"]
                                                  for e in res.trace}
    (path,) = (tmp_path / "prof").iterdir()
    assert b'"kmeans/read_points"' in path.read_bytes()


def _profiled_ranges(prof) -> dict:
    out: dict = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end - e.time_range.start))
    return {k: sorted(v) for k, v in out.items()}


def _assert_mirrored(spans, ranges):
    """Each span has a profiler range of its name, in order, whose
    duration is the span's within 5% or 50 us."""
    by_name: dict = {}
    for e in sorted(spans, key=lambda e: e["ts"]):
        by_name.setdefault(e["name"], []).append(e["dur"])
    assert by_name
    for name, durs in by_name.items():
        got = [d for _, d in ranges.get(name, [])]
        assert len(got) == len(durs), name
        for want, dur in zip(durs, got):
            assert abs(dur - want) <= max(0.05 * want, 50.0), (name, want,
                                                               dur)


def test_spans_are_profiler_ranges_under_a_capture():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer/step", seq=1):
            time.sleep(0.02)
            with tr.span("inner/step"):
                time.sleep(0.005)
        with tr.span("outer/step", seq=2):
            time.sleep(0.01)
    _assert_mirrored([e for e in tr._events if e["ph"] == "X"],
                     _profiled_ranges(prof))


def test_a_job_under_a_capture_mirrors_its_driver_spans(tmp_path):
    corpus = _corpus(tmp_path / "c.txt", lines=1500)
    cfg = JobConfig(input_path=str(corpus), backend="cpu", mapper="device",
                    chunk_bytes=1 << 14, device_chunk_keys=4096,
                    output_path="", metrics=False, trace_out="-")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run_job(cfg, "wordcount")
    driver = [e for e in res.trace if e.get("ph") == "X" and e["tid"] == 0
              and e["name"] != "obs/setup"]
    assert {f"device_map/{s}" for s in STEPS} <= {e["name"] for e in driver}
    _assert_mirrored(driver, _profiled_ranges(prof))


def test_no_capture_no_range_and_a_disabled_tracer_hands_out_null():
    tr = Tracer()
    span = tr.span("x")
    with span:
        assert span._range is None
    assert Tracer(enabled=False).span("x") is NULL_SPAN
