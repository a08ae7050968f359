"""The port's job planner against the JAX package's
(``runtime/planner.py``, ``obs/plan.py``): ``build_plan`` for every
workload, cold and warm (a calibration store written by the JAX
package's code), with and without pinned knobs, gives the same plan
document but for the run identity (the JAX package sees the test suite's
eight virtual CPU devices, the port one CPU); ``publish``, ``finalize``
and ``render`` agree; ``plan='off'`` plans nothing in either package; and
a planned ``pipeline_depth`` reaches the driver through ``Obs.knob``."""

import copy
import types

import numpy as np
import pytest

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import calib as jax_calib
from map_oxidize_tpu.obs import plan as jax_plan
from map_oxidize_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from map_oxidize_tpu.runtime import dispatch as jd
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.planner import build_plan as jax_build_plan
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs, calib, plan
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
from map_oxidize_tpu_torch.runtime import dispatch as td
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.engine import pick_device
from map_oxidize_tpu_torch.runtime.planner import build_plan

WORKLOADS = ("wordcount", "bigram", "invertedindex", "distinct", "kmeans",
             "sort", "join", "sessionize")
PINS = {
    "none": {},
    "all": dict(dispatch_batch=3, pipeline_depth=3, chunk_bytes=1 << 16,
                shuffle_transport="disk", sort_sample=128),
}


@pytest.fixture(autouse=True)
def _fresh_memo(monkeypatch):
    monkeypatch.setattr(td, "_auto_cache", {})
    monkeypatch.setattr(jd, "_auto_cache", {})
    pick_device("cpu")


def _input(tmp_path, workload):
    rng = np.random.default_rng(3)
    if workload == "kmeans":
        path = tmp_path / "pts.npy"
        np.save(path, rng.normal(size=(2000, 4)).astype(np.float32))
    elif workload in ("sort", "join", "sessionize"):
        path = tmp_path / "recs.npy"
        np.save(path, rng.integers(0, 1 << 40, (3000, 2), dtype=np.uint64))
    else:
        path = tmp_path / "corpus.txt"
        path.write_bytes(b"alpha beta gamma\n" * 4000)
    return str(path)


def _jax_store(tmp_path, workload, idents):
    """A calibration store written by the JAX package's code: a run's
    program rows and the workload's wall attribution under each identity
    in ``idents``, with a large feed-wait and exchange share."""
    store = jax_calib.CalibStore(path=str(tmp_path / "calib" /
                                          jax_calib.CALIB_FILE))
    for ident in idents:
        store.accumulate_run(ident, [], {"programs": {
            "kmeans/stream_step": {
                "dispatches": 30, "compiles": 2, "dispatch_ms": 45.0,
                "sampled_device_ms": 8.0, "device_samples": 4,
                "compile_ms": 120.0}}})
        store.accumulate_workload(ident, workload, 3 << 20, {
            "wall_ms": 900.0, "unattributed_ms": 40.0,
            "buckets": {"feed_wait": {"ms": 300.0},
                        "exchange": {"ms": 200.0},
                        "host_sort": {"ms": 100.0},
                        "setup": {"ms": 50.0}}})
    store.save_merged()
    return str(tmp_path / "calib")


def _plans(tmp_path, workload, pins, warm):
    path = _input(tmp_path, workload)
    kw = dict(input_path=path, backend="cpu", **PINS[pins])
    mine_cfg, jax_cfg = JobConfig(**kw), JaxJobConfig(num_shards=1, **kw)
    prior = jprior = None
    if warm:
        d = _jax_store(tmp_path, workload, [calib.run_identity(),
                                             jax_calib.run_identity()])
        prior = calib.CalibStore.load(d)
        jprior = jax_calib.CalibStore.load(d)
    return (build_plan(mine_cfg, workload, calib_prior=prior),
            jax_build_plan(jax_cfg, workload, calib_prior=jprior))


def _less_identity(doc):
    """The plan document less the run identity (top level and in its
    coverage report)."""
    doc = copy.deepcopy(doc)
    doc.pop("identity")
    doc["coverage"].pop("identity")
    return doc


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("pins", list(PINS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_build_plan_matches_jax(tmp_path, workload, pins, warm):
    mine, theirs = _plans(tmp_path, workload, pins, warm)
    assert _less_identity(mine) == _less_identity(theirs)
    assert mine["identity"] == {"platform": "cpu", "device_count": 1,
                                "topology": "1x1"}
    assert set(mine["knobs"]) == set(theirs["knobs"]) == {
        "dispatch_batch", "pipeline_depth", "chunk_bytes",
        "shuffle_transport", "sort_sample", "exchange_collective"}
    assert mine["provenance"] == ("curve" if warm else "platform_default")
    assert ("predicted" in mine) == warm
    if pins == "all":
        assert mine["knobs"]["pipeline_depth"]["provenance"] == "pinned"


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_publish_finalize_and_render_match_jax(tmp_path, warm):
    mine, theirs = _plans(tmp_path, "kmeans", "none", warm)
    regs = MetricsRegistry(), JaxRegistry()
    plan.publish(regs[0], mine)
    jax_plan.publish(regs[1], theirs)
    assert regs[0].summary() == regs[1].summary()
    attrib_doc = {"wall_ms": 812.5, "unattributed_ms": 12.0,
                  "buckets": {"feed_wait": {"ms": 250.0},
                              "setup": {"ms": 60.0}}}
    obs = types.SimpleNamespace(registry=regs[0])
    jobs = types.SimpleNamespace(registry=regs[1])
    jobs.registry.comms_table = lambda: []
    plan.finalize(obs, mine, attrib_doc)
    jax_plan.finalize(jobs, theirs, attrib_doc)
    assert _less_identity(mine) == _less_identity(theirs)
    assert regs[0].summary() == regs[1].summary()
    assert ("plan/model_error_pct" in regs[0].summary()) == warm
    assert plan.render(mine) == jax_plan.render(theirs)


def test_plan_off_plans_nothing_in_either_package(tmp_path):
    path = _input(tmp_path, "wordcount")
    kw = dict(input_path=path, backend="cpu", metrics=False, output_path="",
              plan="off")
    mine = run_job(JobConfig(**kw), "wordcount")
    theirs = jax_run_job(JaxJobConfig(num_shards=1, **kw), "wordcount")
    for m in (mine.metrics, theirs.metrics):
        assert not [k for k in m if k.startswith(("plan/", "calib/"))]


def test_a_curve_deepened_pipeline_reaches_the_driver(tmp_path):
    """A warm store with a 33% feed-wait share deepens ``pipeline_depth``
    from 2 to 3 (``curve`` provenance); the word-count driver's prefetch
    runs at 3 (``pipeline/depth``), read through ``Obs.knob``, and the
    config is untouched."""
    path = _input(tmp_path, "wordcount")
    d = _jax_store(tmp_path, "wordcount", [calib.run_identity()])
    cfg = JobConfig(input_path=path, backend="cpu", metrics=False,
                    output_path="", calib_dir=d)
    res = run_job(cfg, "wordcount")
    assert res.metrics["plan/pipeline_depth"] == 3
    assert res.metrics["plan/pipeline_depth_provenance"] == "curve"
    assert res.metrics["pipeline/depth"] == 3 and cfg.pipeline_depth == 2
    assert res.metrics["calib/store_runs"] == 1


def test_knob_falls_back_without_a_plan():
    obs = Obs.from_config(JobConfig(backend="cpu"))
    assert obs.knob("pipeline_depth", 5) == 5
    obs.plan = {"knobs": {"pipeline_depth": {"value": 3}}}
    assert obs.knob("pipeline_depth", 5) == 3
    obs.finish_xprof()
