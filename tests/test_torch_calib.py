"""The port's calibration store against the JAX package's
(``obs/calib.py``): a store written by a job of either package loads and
merges in the other; the read-side curves (``program_curve``,
``workload_curve``, ``interpolate_latency_ms``) and the coverage report
agree on the same seeded store; a torn store or a foreign identity
refuses in both; and ``run_identity`` reads ``host`` before a job resolved
its device and ``cpu`` after, never initialising CUDA."""

import json

import numpy as np
import pytest
import torch

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import calib as jax_calib
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import calib
from map_oxidize_tpu_torch.runtime import run_job

IDENT = {"platform": "gpu", "device_count": 1, "topology": "1x1"}


def _seeded_store(mod, seed=0):
    """The same store through ``mod``'s accumulate path: comms rows over
    eight payload buckets for two collectives, program and workload
    rows, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    store = mod.CalibStore()
    rows = []
    for coll in ("all_to_all", "all_gather"):
        for k in range(8):
            calls = int(rng.integers(1, 20))
            rows.append({"collective": coll, "program": "p",
                         "count": calls,
                         "bytes": float(calls * (1 << (12 + 2 * k))),
                         "latency_ms": {"count": int(rng.integers(0, 6)),
                                        "mean": float(rng.uniform(0.1, 9))},
                         "shape": [k]})
    store.accumulate_run(IDENT, rows, {"programs": {
        "kmeans/stream_step": {"dispatches": 50, "compiles": 1,
                               "dispatch_ms": 12.5,
                               "sampled_device_ms": 7.25,
                               "device_samples": 4, "compile_ms": 90.0}}})
    store.accumulate_workload(IDENT, "kmeans", 5 << 20, {
        "wall_ms": 1234.5, "unattributed_ms": 34.5,
        "buckets": {"feed_wait": {"ms": 200.0},
                    "device_compute": {"ms": 800.0}}})
    return store


def test_curves_match_jax():
    mine, theirs = _seeded_store(calib), _seeded_store(jax_calib)
    assert mine.doc == theirs.doc
    assert calib.program_curve(mine, IDENT, "kmeans/stream_step") == (
        jax_calib.program_curve(theirs, IDENT, "kmeans/stream_step"))
    assert calib.workload_curve(mine, IDENT, "kmeans") == (
        jax_calib.workload_curve(theirs, IDENT, "kmeans"))
    assert calib.program_curve(mine, IDENT, "nope") is None
    for coll in ("all_to_all", "all_gather"):
        for nbytes in (0, 1000, 5e4, 3e6, 7e7, 1e12):
            for prog in (None, "p"):
                assert calib.interpolate_latency_ms(
                    mine, IDENT, coll, nbytes, program=prog) == (
                    jax_calib.interpolate_latency_ms(
                        theirs, IDENT, coll, nbytes, program=prog))
    cells = [{"collective": c, "bucket": b}
             for c in ("all_to_all", "all_gather")
             for b in ("4KB", "256KB", "1GB")]
    assert calib.coverage_report(mine, IDENT, cells) == (
        jax_calib.coverage_report(theirs, IDENT, cells))
    assert calib.render(mine) == jax_calib.render(theirs)


def _job(pkg, tmp_path, calib_dir):
    path = tmp_path / "pts.npy"
    if not path.exists():
        rng = np.random.default_rng(1)
        np.save(path, rng.normal(size=(3000, 4)).astype(np.float32))
    kw = dict(input_path=str(path), backend="cpu", metrics=False,
              output_path="", kmeans_k=4, kmeans_iters=2, chunk_bytes=2048,
              kmeans_device_fit_bytes=64, dispatch_batch=2,
              calib_dir=str(calib_dir))
    if pkg == "port":
        return run_job(JobConfig(**kw), "kmeans")
    return jax_run_job(JaxJobConfig(num_shards=1, **kw), "kmeans")


@pytest.mark.parametrize("order", [("port", "jax"), ("jax", "port")])
def test_stores_cross_both_ways(tmp_path, order):
    """One package's job writes the store, the other's job loads it
    (``calib/store_runs``) and merges its own rows into the same file;
    both packages then load the file."""
    d = tmp_path / "calib"
    first = _job(order[0], tmp_path, d)
    assert first.metrics["calib/rows_merged"] >= 2
    second = _job(order[1], tmp_path, d)
    assert second.metrics["calib/store_runs"] == 1
    assert second.metrics["calib/runs"] == 2
    for mod in (calib, jax_calib):
        doc = mod.CalibStore.load(str(d)).doc
        assert doc["runs"] == 2 and doc["schema"] == "moxt-calib-v1"
        progs = {r["program"] for r in doc["programs"].values()}
        assert "kmeans/stream_step" in progs
        assert {r["workload"] for r in doc["workloads"].values()} == {
            "kmeans"}


@pytest.mark.parametrize("fault", ["foreign_identity", "schema", "version",
                                   "malformed_key", "unreadable"])
def test_a_torn_store_refuses_in_both(tmp_path, fault):
    doc = _seeded_store(jax_calib).doc
    if fault == "foreign_identity":
        key = next(iter(doc["programs"]))
        doc["programs"][key]["platform"] = "tpu"
    elif fault == "schema":
        doc["schema"] = "other"
    elif fault == "version":
        doc["version"] = 2
    elif fault == "malformed_key":
        doc["workloads"]["gpu|1|kmeans"] = {}
    path = tmp_path / "calib.json"
    path.write_text("{not json" if fault == "unreadable"
                    else json.dumps(doc))
    for mod in (calib, jax_calib):
        with pytest.raises(mod.CalibMismatch):
            mod.CalibStore.load(str(path))


def test_a_refused_store_leaves_the_job_uncalibrated(tmp_path):
    d = tmp_path / "calib"
    d.mkdir()
    (d / "calib.json").write_text(json.dumps({"schema": "x"}))
    res = _job("port", tmp_path, d)
    assert res.metrics["calib/load_refused"] == 1
    assert "calib/rows_merged" not in res.metrics


def test_run_identity_reads_host_then_cpu(monkeypatch):
    from map_oxidize_tpu_torch.runtime.engine import pick_device

    monkeypatch.setattr(calib, "_RESOLVED_CPU", [False])
    assert calib.run_identity() == {"platform": "host", "device_count": 0,
                                    "topology": "1x0"}
    pick_device("cpu")
    assert calib.run_identity(2) == {"platform": "cpu", "device_count": 1,
                                     "topology": "2x1"}
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("nbytes", [0, 1, 1023, 1024, 5 << 20, 3 << 30,
                                    1 << 41])
def test_shape_bucket_matches_jax(nbytes):
    assert calib.shape_bucket(nbytes) == jax_calib.shape_bucket(nbytes)
    label = calib.shape_bucket(nbytes)
    assert calib.bucket_index(label) == jax_calib.bucket_index(label)
