"""HiBench KMeans at its large profile (config ``hibench-kmeans-large``):
the benchmark's generator of its points, the configuration's sizes and its
cell, the port's job against the plain float64 reference on seeded data at
a small size on the CPU, the job's count of the fused assign + sum's calls,
and the ``kmeans.assign_sum_ms`` reader.  One test runs the CUDA kernel at
the cell's own size and skips without a card (on a card:
``python -m pytest tests/test_torch_hibench_kmeans.py -m cuda``)."""

import hashlib
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from portbench.bench import Bench
from portbench.generators import hibench_kmeans_points as gen
from portbench.reference import kmeans as reference

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = "kmeans.hibench-large"
CONFIG = "hibench-kmeans-large"
#: the k-means per-layer metrics that list the cell
LAYER = {"kmeans.iter_ms", "kmeans.transfer_ms", "kmeans.read_points_ms",
         "kmeans.copy_points_ms", "kmeans.envelope_ms",
         "kmeans_assign_sum_roofline", "mfu.kmeans",
         "device_idle_pct.kmeans", "kmeans.assign_sum_ms"}


def _config() -> dict:
    return Bench(ROOT).config(CONFIG)


def _spec(n: int) -> dict:
    return dict(_config()["dataset"], n=n, block_rows=4096)


def _digest(path: str) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


# --- the generator ----------------------------------------------------------


def test_one_seed_same_bytes_two_seeds_differ(tmp_path):
    spec = _spec(10_000)
    paths = []
    for name, seed in (("a", 2**31 + 3), ("b", 2**31 + 3), ("c", 2**31 + 4)):
        (tmp_path / name).mkdir()
        info = gen.generate(spec, seed, tmp_path / name, "cpu")
        assert [p.name for p in (tmp_path / name).iterdir()] == ["points.npy"]
        assert info["bytes"] == Path(info["path"]).stat().st_size
        paths.append(info["path"])
    a, b, c = (_digest(p) for p in paths)
    assert a == b and a != c


def test_points_are_real_numbers_from_five_components(tmp_path):
    """float32 coordinates that are not integers, each point near one of
    the five centres that the generator draws first, every centre with
    about a fifth of the points."""
    spec = _spec(20_000)
    info = gen.generate(spec, 2**31 + 5, tmp_path, "cpu")
    pts = torch.from_numpy(np.load(info["path"]))
    assert pts.shape == (20_000, 20) and pts.dtype == torch.float32
    assert not torch.equal(pts, pts.round())
    g = torch.Generator().manual_seed(2**31 + 5)
    mu = gen.centers(spec, g, "cpu")
    assert mu.shape == (5, 20)
    assert float(mu.min()) >= 0.0 and float(mu.max()) < 100.0
    dist = torch.cdist(pts.double(), mu.double())
    near = dist.argmin(1)
    counts = torch.bincount(near, minlength=5)
    assert (counts > 0.17 * 20_000).all() and (counts < 0.23 * 20_000).all()
    # a point lies about spread * sqrt(d) from its centre
    own = dist.gather(1, near[:, None]).squeeze(1)
    assert 40.0 < float(own.mean()) < 50.0


# --- the configuration and the cell -----------------------------------------


def test_the_sizes_are_hibench_large():
    cfg = _config()
    assert (cfg["n"], cfg["d"], cfg["k"], cfg["max_iteration"],
            cfg["num_of_clusters"]) == (20_000_000, 20, 10, 5, 5)
    ds, params = cfg["dataset"], cfg["job_params"]
    assert (ds["n"], ds["d"], ds["components"]) == (20_000_000, 20, 5)
    assert params == {"kmeans_k": 10, "kmeans_iters": 5,
                      "kmeans_precision": "highest"}
    assert cfg["reduced"] == [] and cfg["assumed"] and cfg["limits"]
    assert cfg["limits"] == {"centroid_gap_max": 5e-5,
                             "assign_mismatch": 2e-4}
    assert len(cfg["source"]) <= 200
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in manifest["configs"] if c["name"] == CONFIG]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


def test_the_cell_is_one_card_of_the_resident_mix():
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "kmeans.resident", 1)
    assert [m["name"] for m in bench.end_to_end(CELL)] == [
        "kmeans_job_s", "setup_s"]
    assert {m["name"] for m in bench.per_layer(CELL)} == LAYER
    (new,) = [m for m in bench.manifest["per_layer"]
              if m["name"] == "kmeans.assign_sum_ms"]
    assert new["workloads"] == ["kmeans.sift1m-ivf4096", CELL]
    assert (new["unit"], new["source"], new["layer"], new["moves"]) == (
        "ms", "device_trace", "kernels", "kmeans_job_s")


# --- the port against the plain reference -----------------------------------

#: a HiBench-shaped size (d=20, k=10, 5 components, 5 iterations) at which
#: no point lies within float32 rounding of a boundary: about 400 points a
#: component.  At 5e4 points a few points do, and one such point moves its
#: centroid by some 4e-5 of the median centroid length, past the cell's
#: limits; at the cell's 2e7 points one moves it by some 1e-7 (PERF.md)
SMALL = {"dataset": {"n": 2000, "block_rows": 4096}}


@pytest.fixture(scope="module")
def small_fit(tmp_path_factory):
    """The port's job (``mapper='device'`` through ``run_job``) and the
    TF32 control on one seeded dataset, with the float64 reference."""
    from portbench.run import merged

    tmp = tmp_path_factory.mktemp("hibench_kmeans")
    cfg = merged(_config(), SMALL)
    ds = gen.generate(cfg["dataset"], 2**31 + 101, tmp, "cpu")
    out = tmp / cfg["output"]
    res = run_job(JobConfig(input_path=ds["path"], backend="cpu",
                            output_path=str(out), metrics=False,
                            mapper="device", **cfg["job_params"]), "kmeans")
    (tmp / "control").mkdir()
    control = reference.control_outputs(cfg, ds, tmp / "control", "cpu")
    want = reference.expected(cfg, ds, "cpu")
    return (cfg, res, reference.judge(cfg, ds, want, [out], "cpu"),
            reference.judge(cfg, ds, want, control, "cpu"))


def test_the_port_is_the_float64_reference_to_float32_rounding(small_fit):
    """No centroid farther than ``MOVED`` from the reference's, no point
    assigned elsewhere: inside the cell's limits."""
    cfg, res, got, _control = small_fit
    assert res.metrics["kmeans_mode"] == "device"
    assert got["centroids_moved"] == 0 and got["assign_mismatch"] == 0
    assert got["centroid_gap_max"] <= reference.MOVED
    assert all(got[name] <= limit for name, limit in cfg["limits"].items())


def test_the_tf32_control_fails_every_limit(small_fit):
    cfg, _res, got, control = small_fit
    assert control["centroids_moved"] > 0
    assert all(control[name] > limit
               for name, limit in cfg["limits"].items())
    assert control["centroid_gap_max"] > 1000 * got["centroid_gap_max"]


#: one harness run of the cell on the CPU at the small size, in a fresh
#: interpreter: ``run.main`` refuses a process that holds the JAX package,
#: which other test modules load
HARNESS = """
import contextlib, io, json, sys
sys.path.insert(0, '.')
from portbench import run
for trace in (0, 1):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \\
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(['--workload', {cell!r}, '--seed', '{seed}',
                       '--seconds', '0.3', '--trace', str(trace)],
                      backend='cpu', overrides={overrides!r})
    print(json.dumps({{"rc": rc,
                      "line": out.getvalue().strip().splitlines()[-1]}}))
"""


def test_a_harness_run_of_the_cell_is_correct():
    """``portbench/run.py`` end to end on the CPU at the small size, untraced
    and traced: correct, every check inside its limit, and the per-layer
    metrics that a CPU run can read (no device time and no card's peak, so
    no roofline, ``mfu.kmeans``, idle share or ``kmeans.assign_sum_ms``)."""
    code = HARNESS.format(cell=CELL, seed=2**31 + 103, overrides=SMALL)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    runs = [json.loads(r) for r in out.stdout.strip().splitlines()[-2:]]
    assert [r["rc"] for r in runs] == [0, 0]
    lines = [json.loads(r["line"]) for r in runs]
    for line in lines:
        assert line["correct"] is True and line["failed"] == 0
        assert set(line["checks"]) == {"centroid_gap_max", "assign_mismatch"}
        assert all(c["value"] <= c["limit"]
                   for c in line["checks"].values())
    assert set(lines[0]["metrics"]) == {"kmeans_job_s", "setup_s"}
    assert set(lines[1]["metrics"]) == {
        "kmeans.iter_ms", "kmeans.transfer_ms", "kmeans.read_points_ms",
        "kmeans.copy_points_ms", "kmeans.envelope_ms"}


# --- the job's counters and the reader ---------------------------------------


@pytest.mark.parametrize("route,calls", [
    (dict(mapper="device"), lambda iters, chunks: iters),
    (dict(kmeans_device_fit_bytes=64, chunk_bytes=4 * (20 + 2 * 10) * 700,
          dispatch_batch=2), lambda iters, chunks: iters * chunks),
])
def test_the_job_counts_its_assign_sum_calls(tmp_path, route, calls):
    """``kmeans/assign_sum_calls`` is the fit's calls of the fused assign
    + sum: one an iteration resident, one a chunk an iteration streamed;
    no launch plan is recorded off a card."""
    info = gen.generate(_spec(3000), 2**31 + 9, tmp_path, "cpu")
    res = run_job(JobConfig(input_path=info["path"], backend="cpu",
                            kmeans_k=10, kmeans_iters=3, output_path="",
                            metrics=False, **route), "kmeans")
    m = res.metrics
    assert m["kmeans/assign_sum_calls"] == calls(3, -(-3000 // 700))
    assert not any(key.startswith("kmeans/plan_") for key in m)


def _run_with(jobs, kernel_s, name="kmeans_assign_sum"):
    trace = types.SimpleNamespace(
        kernel_seconds=lambda tag: kernel_s if tag == name else 0.0)
    return types.SimpleNamespace(
        trace=trace, done=[{"metrics": m} for m in jobs])


def test_the_reader_divides_device_time_by_the_counted_calls():
    read = Bench(ROOT).reader("layer_metrics", "kmeans.assign_sum_ms")
    jobs = [{"iters": 5, "kmeans/assign_sum_calls": 5},
            {"iters": 5, "kmeans/assign_sum_calls": 7}]
    assert read(_run_with(jobs, 0.06)) == pytest.approx(5.0)
    # a port without the counter, a capture without the kernel, no trace
    assert read(_run_with([{"iters": 5}], 0.06)) is None
    assert read(_run_with(jobs, 0.0)) is None
    assert read(types.SimpleNamespace(trace=None, done=[])) is None


# --- the kernel at the cell's size, on a card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_sums_at_the_cells_size(cuda):
    """``fused_assign_sum`` at n=2e7, d=20, k=10 against a float64
    ``index_add_`` of the same assignment.  The points come from 10
    components 50 + 100 e_j (spread 10, the cell's), each boundary 7
    spreads from both centres, and the centroids sit at the centres, so no
    point lies within float32 rounding of a boundary and both assign
    alike.  Counts (about 2M a centroid, under 2^24) are exact; each mean
    lies within the cell's ``MOVED`` (1e-6) of the float64 mean's length,
    as the cell's comparison demands."""
    from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum

    n, d, k, spread = 20_000_000, 20, 10, 10.0
    mu = (50.0 + 100.0 * torch.eye(k, d, device=cuda)).contiguous()
    g = torch.Generator(device=cuda).manual_seed(2**31 + 29)
    comp = torch.randint(0, k, (n,), generator=g, device=cuda)
    p = torch.randn((n, d), generator=g, device=cuda).mul_(spread).add_(
        mu[comp])
    sums, counts = fused_assign_sum(p, mu, k, "highest")
    torch.cuda.synchronize()
    s64 = torch.zeros((k, d), dtype=torch.float64, device=cuda)
    c64 = torch.zeros(k, dtype=torch.float64, device=cuda)
    c = mu.double()
    for lo in range(0, n, 1 << 20):
        blk = p[lo:lo + (1 << 20)].double()
        cid = torch.argmin((c * c).sum(1) - 2.0 * blk @ c.T, dim=1)
        s64.index_add_(0, cid, blk)
        c64 += torch.bincount(cid, minlength=k).double()
    assert torch.equal(counts.double(), c64)
    assert float(c64.max()) < 2**24
    mean64 = s64 / c64[:, None]
    mean = (sums / counts[:, None]).double()
    err = (mean - mean64).norm(dim=1) / mean64.norm(dim=1)
    assert float(err.max()) <= reference.MOVED, err.tolist()
