"""The per-layer metrics that read the port's own counters: each reads a
number in a traced run of its cell, and nothing from a port without the
counter (the run's result line then leaves the metric out)."""

from __future__ import annotations

import types

import pytest

from portbench.bench import Bench
from portbench.tests.conftest import CHECKOUT, run_cell

COUNTERS = {
    "wordcount.hibench-large.device": (
        "wc.read_ms", "wc.stage_ms", "wc.enqueue_ms", "wc.fetch_wait_ms",
        "wc.dict_ms", "wc.envelope_ms"),
    "kmeans.sift1m-ivf4096": (
        "kmeans.read_points_ms", "kmeans.copy_points_ms",
        "kmeans.envelope_ms"),
}


@pytest.mark.parametrize("cell", list(COUNTERS))
def test_a_traced_run_reads_every_counter(cell, capsys):
    line = run_cell(cell, capsys, trace=1)
    got = line["metrics"]
    for name in COUNTERS[cell]:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    labels = [label for label, _s in line["breakdown"]["idle_gaps"]]
    assert labels


@pytest.mark.parametrize("name", [n for ns in COUNTERS.values() for n in ns])
def test_a_port_without_the_counter_gives_nothing(name):
    read = Bench(CHECKOUT).reader("layer_metrics", name)
    run = types.SimpleNamespace(done=[{"metrics": {"chunks": 3,
                                                   "iters": 25}}])
    assert read(run) is None
    assert read(types.SimpleNamespace(done=[])) is None


def test_per_chunk_metrics_take_each_job_s_counter_over_its_chunks():
    read = Bench(CHECKOUT).reader("layer_metrics", "wc.read_ms")
    jobs = [{"metrics": {"device_map/read_ms": ms, "chunks": n}}
            for ms, n in ((100.0, 4), (90.0, 3), (500.0, 10))]
    assert read(types.SimpleNamespace(done=jobs)) == 30.0
