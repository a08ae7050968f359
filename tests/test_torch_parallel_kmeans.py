"""The port's sharded k-means against the JAX package's at the same shard
count: the resident fit (``kmeans/fit_sharded``) and the streamed fit
through the mesh (the sharded ``kmeans/stream_step``) on 2, 3 and 8 CPU
slots.  On separated blobs the centroids agree within 1e-5 * max|x| and
the assignment counts are equal; on integer-valued points (exact f32
sums in any order) they are bit-equal, and two port runs are bit-equal
whatever the order.  The shard count is checkpoint identity, and an
8-shard snapshot resumes across the packages both ways."""

import numpy as np
import pytest
import torch

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.workloads.kmeans import assign_points

torch.set_num_threads(2)

K = 6
MODES = {
    "device": dict(mapper="device"),
    "stream_device": dict(kmeans_device_fit_bytes=64, chunk_bytes=4096,
                          dispatch_batch=2),
}


def _blobs(seed=1, n=3001, d=4, integer=False):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 20, size=(K, d))
    pts = centres[rng.integers(0, K, size=n)] + rng.normal(0, 0.5, (n, d))
    pts[:K] = centres
    if integer:
        pts = np.round(pts)
    return pts.astype(np.float32)


def _fresh_ledgers():
    """Both packages' launch ledgers, jit caches and dispatch memos as in a
    fresh process, so a job's compiles (and their key sets) are its own."""
    import jax

    from map_oxidize_tpu.obs.compile import LEDGER as JAX_LEDGER
    from map_oxidize_tpu.runtime import dispatch as jax_dispatch
    from map_oxidize_tpu_torch.obs.compile import LEDGER
    from map_oxidize_tpu_torch.runtime import dispatch

    jax.clear_caches()
    JAX_LEDGER.programs.clear()
    LEDGER.reset()
    jax_dispatch._auto_cache.clear()
    dispatch._auto_cache.clear()


def _run(tmp, pkg, pts, S, iters=4, **kw):
    _fresh_ledgers()
    path = tmp / "pts.npy"
    if not path.exists():
        np.save(path, pts)
    cfg_cls, run = ((JobConfig, run_job) if pkg == "port"
                    else (JaxJobConfig, jax_run_job))
    return run(cfg_cls(input_path=str(path), backend="cpu", metrics=False,
                       output_path="", kmeans_k=K, kmeans_iters=iters,
                       num_shards=S, **kw), "kmeans")


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_fit_matches_jax(tmp_path, mode, S):
    pts = _blobs()
    port = _run(tmp_path, "port", pts, S, **MODES[mode])
    jax = _run(tmp_path, "jax", pts, S, **MODES[mode])
    tol = 1e-5 * float(np.abs(pts).max())
    np.testing.assert_allclose(port.centroids, jax.centroids, rtol=0,
                               atol=tol)
    counts = [np.bincount(assign_points(pts, r.centroids), minlength=K)
              for r in (port, jax)]
    np.testing.assert_array_equal(counts[0], counts[1])
    m = port.metrics
    assert m["kmeans_mode"] == jax.metrics["kmeans_mode"] == mode
    assert m["kmeans_shards"] == jax.metrics["kmeans_shards"] == S
    pk, jk = set(m), set(jax.metrics)
    assert pk - jk == {"device", "obs/envelope_ms"}
    assert jk - pk == set()
    for k in pk & jk:
        if k.startswith("comms/"):
            assert m[k] == jax.metrics[k], k


@pytest.mark.parametrize("mode", list(MODES))
def test_integer_points_are_bit_equal_to_jax_and_run_to_run(tmp_path, mode):
    pts = _blobs(seed=4, integer=True)
    a = _run(tmp_path, "port", pts, 8, **MODES[mode])
    b = _run(tmp_path, "port", pts, 8, **MODES[mode])
    j = _run(tmp_path, "jax", pts, 8, **MODES[mode])
    assert a.centroids.tobytes() == b.centroids.tobytes()
    assert a.centroids.tobytes() == j.centroids.tobytes()


def test_bf16_sharded_fit_matches_jax(tmp_path):
    pts = _blobs(seed=5)
    kw = dict(MODES["device"], kmeans_precision="bf16")
    port = _run(tmp_path, "port", pts, 8, **kw)
    jax = _run(tmp_path, "jax", pts, 8, **kw)
    counts = [np.bincount(assign_points(pts, r.centroids), minlength=K)
              for r in (port, jax)]
    np.testing.assert_array_equal(counts[0], counts[1])
    np.testing.assert_allclose(port.centroids, jax.centroids, rtol=0,
                               atol=1e-5 * float(np.abs(pts).max()))


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("mode", list(MODES))
def test_an_8_shard_snapshot_resumes_across_the_packages(tmp_path, mode,
                                                         first, second):
    """Two iterations in ``first`` (snapshot kept), two more resumed in
    ``second``: bit-equal (integer points) to four straight iterations;
    a different shard count does not resume the snapshot."""
    pts = _blobs(seed=6, integer=True)
    ck = tmp_path / "ck"
    _run(tmp_path, first, pts, 8, iters=2, checkpoint_dir=str(ck),
         keep_intermediates=True, **MODES[mode])
    r = _run(tmp_path, second, pts, 8, iters=4, checkpoint_dir=str(ck),
             keep_intermediates=True, **MODES[mode])
    assert r.metrics["resumed_iters"] == 2
    straight = _run(tmp_path, first, pts, 8, iters=4, **MODES[mode])
    assert r.centroids.tobytes() == straight.centroids.tobytes()
    other = _run(tmp_path, "port", pts, 4, iters=4, checkpoint_dir=str(ck),
                 **MODES[mode])
    assert "resumed_iters" not in other.metrics


def test_sharded_fit_functions_take_explicit_meshes(tmp_path):
    """``kmeans_fit_sharded`` / ``kmeans_fit_streamed`` on a hand-made
    mesh: on integer points one shard and five (the resident fit), one
    and three (the stream) equal the single-device fits bit for bit."""
    from map_oxidize_tpu_torch.parallel.kmeans import (
        kmeans_fit_sharded,
        kmeans_fit_streamed,
    )
    from map_oxidize_tpu_torch.parallel.mesh import make_mesh
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_device,
        kmeans_fit_streamed_device,
    )

    pts = _blobs(seed=7, integer=True)
    path = tmp_path / "p.npy"
    np.save(path, pts)
    c0 = pts[:K]
    one = make_mesh(1, "cpu")
    want = kmeans_fit_device(pts, c0, iters=3, device="cpu")
    assert (kmeans_fit_sharded(pts, c0, iters=3, mesh=one).tobytes()
            == want.tobytes())
    seen = []
    got = kmeans_fit_sharded(pts, c0, iters=3, mesh=make_mesh(5, "cpu"),
                             on_iter=lambda i, c: seen.append(i))
    assert seen == [1, 2, 3] and got.tobytes() == want.tobytes()
    want = kmeans_fit_streamed_device(str(path), c0, iters=2,
                                      chunk_rows=500, device="cpu",
                                      dispatch_batch=3)
    for S in (1, 3):
        got = kmeans_fit_streamed(str(path), c0, iters=2, chunk_rows=500,
                                  mesh=make_mesh(S, "cpu"),
                                  dispatch_batch=3)
        assert got.tobytes() == want.tobytes()


def test_sharded_stream_partials_hold_the_one_device_counts(tmp_path):
    """The sharded stream's ``partials`` (each iteration's psummed
    ``(k, d+1)`` accumulator) against the single-device stream's on blobs,
    as ``chip_smoke.py`` holds the 8-slot iteration on the card: counts
    equal, sums within 1e-5 * count * max|x|, centroids within
    1e-5 * max|x|."""
    from map_oxidize_tpu_torch.parallel.kmeans import kmeans_fit_streamed
    from map_oxidize_tpu_torch.parallel.mesh import make_mesh
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_streamed_device,
    )

    pts = _blobs(seed=9, n=5003)
    path = tmp_path / "p.npy"
    np.save(path, pts)
    c0 = pts[:K]
    one, eight = [], []
    want = kmeans_fit_streamed_device(str(path), c0, iters=2,
                                      chunk_rows=771, device="cpu",
                                      dispatch_batch=1, partials=one)
    got = kmeans_fit_streamed(str(path), c0, iters=2, chunk_rows=771,
                              mesh=make_mesh(8, "cpu"), dispatch_batch=1,
                              partials=eight)
    scale = float(np.abs(pts).max())
    assert len(one) == len(eight) == 2
    for a, b in zip(one, eight):
        assert np.array_equal(a[:, -1], b[:, -1])
        assert (np.abs(a[:, :-1] - b[:, :-1])
                <= 1e-5 * a[:, -1:] * scale).all()
    assert np.abs(got - want).max() <= 1e-5 * scale
