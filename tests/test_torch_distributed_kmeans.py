"""The port's multi-process k-means (``kmeans_mode`` ``dist_device``) on
the CPU: 2 Gloo processes x 4 local slots of one S=8 mesh.

Each local shard runs the fused assign + sum (``kmeans_assign_sum``'s
plain version on the CPU) on its block, and the one ``(k, d+1)`` psum per
iteration gathers the 8 partials and adds them in global shard order, so
the two processes' centroids are bit-equal to each other AND to the
port's one-process S=8 fit.  Against the JAX package's in-process S=8 fit
the counts are equal and the centroids within 1e-5 * max|x| (the JAX
sharded fit assigns through its own XLA product).  Process 0's
``--output`` carries the replicated result; a resumed fit reads process
0's snapshot on both processes.
"""

import numpy as np
import pytest

import test_torch_distributed as td

SMALL_KM = dict(num_shards=8, kmeans_k=4, kmeans_iters=3)


def _blobs(path, n=1000, d=8, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, size=(4, d)).astype(np.float32)
    pts = (centers[rng.integers(0, 4, n)]
           + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)
    pts[:4] = centers
    np.save(path, pts)
    return pts


def _centroids(payload):
    return np.frombuffer(bytes.fromhex(payload["centroids"]),
                         np.float32).reshape(4, -1)


def _counts(pts, c):
    d2 = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
    return np.bincount(d2.argmin(1), minlength=c.shape[0])


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_two_process_kmeans_bit_equal_to_one_process(tmp_path, precision):
    from map_oxidize_tpu.parallel.kmeans import (
        kmeans_fit_sharded as jax_fit,
    )
    from map_oxidize_tpu_torch.parallel.kmeans import kmeans_fit_sharded

    pts = _blobs(tmp_path / "p.npy")
    out = tmp_path / "cent.npy"
    cfg = dict(SMALL_KM, input_path=str(tmp_path / "p.npy"),
               output_path=str(out), kmeans_precision=precision)
    results = td.launch(tmp_path, "kmeans", cfg)
    got = [_centroids(r) for r in results]
    assert got[0].tobytes() == got[1].tobytes()
    one = kmeans_fit_sharded(pts, pts[:4].copy(), iters=3, num_shards=8,
                             backend="cpu", precision=precision)
    assert got[0].tobytes() == one.tobytes()
    ref = np.asarray(jax_fit(pts, pts[:4].copy(), iters=3, num_shards=8,
                             backend="cpu", precision=precision))
    bound = 1e-5 * float(np.abs(pts).max())
    if precision == "highest":
        np.testing.assert_allclose(got[0], ref, rtol=0, atol=bound)
        np.testing.assert_array_equal(_counts(pts, got[0]),
                                      _counts(pts, ref))
    np.testing.assert_array_equal(np.load(out), got[0])
    # the comms accounting: one (k, d+1) psum per iteration
    assert "comms/psum/kmeans/fit_sharded/bytes" in results[0]["metric_keys"]


def test_two_process_kmeans_checkpoint_resume(tmp_path):
    """A 2-iteration run snapshots through process 0 (kept); the
    3-iteration run resumes it on BOTH processes and runs the last one:
    the straight one-process 3-iteration fit, bit for bit."""
    from map_oxidize_tpu_torch.parallel.kmeans import kmeans_fit_sharded

    pts = _blobs(tmp_path / "r.npy", seed=7)
    cfg = dict(SMALL_KM, input_path=str(tmp_path / "r.npy"),
               output_path="", checkpoint_dir=str(tmp_path / "kck"))
    results = td.launch(tmp_path, "kmeans", cfg, kmeans_resume=True)
    got = [_centroids(r) for r in results]
    assert got[0].tobytes() == got[1].tobytes()
    assert [r["resumed_iters"] for r in results] == [2, 2]
    one = kmeans_fit_sharded(pts, pts[:4].copy(), iters=3, num_shards=8,
                             backend="cpu")
    assert got[0].tobytes() == one.tobytes()
