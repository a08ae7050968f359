"""The port's k-means against the JAX package's: the fused assign + sum
(the port's plain version on the CPU against the Pallas kernel in interpret
mode and against ``assign_and_sum``), the device-resident fit, and the job
through ``run_job``.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.ops.kmeans_kernel import fused_assign_sum as jax_fused
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.workloads import kmeans as jkm
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.workloads import kmeans as tkm

torch.set_num_threads(2)

N, D, K = 2048 + 777, 16, 32


def _inputs(seed=21):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(N, D)).astype(np.float32)
    c = rng.normal(size=(K, D)).astype(np.float32)
    w = (rng.random(N) > 0.3).astype(np.float32)
    return p, c, w


def _blobs(seed, n=4000, d=8, k=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    pts = (centers[rng.integers(0, k, size=n)]
           + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)
    pts[:k] = centers  # first-k init starts one point per blob
    return pts


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_fused_assign_sum_matches_pallas_and_xla(precision, weighted):
    """Counts equal, sums within rtol 1e-5 / atol 1e-4 (the summation order
    differs between the three), against the Pallas kernel (interpret mode)
    and the XLA ``assign_and_sum`` of the same mode."""
    p, c, w = _inputs()
    tw = torch.from_numpy(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    sums, counts = fused_assign_sum(torch.from_numpy(p), torch.from_numpy(c),
                                    K, precision, w=tw)
    assert fused_assign_sum.launches == 0  # CPU tensors take the plain form
    for ref in (jax_fused(jnp.asarray(p), jnp.asarray(c), K, precision,
                          w=jw, interpret=True),
                jkm.assign_and_sum(jnp.asarray(p), jnp.asarray(c), K,
                                   precision, w=jw)):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(sums.numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-4)
    total = w.sum() if weighted else N
    assert counts.sum().item() == total


def test_bf16_points_stored_bf16_give_the_same_result():
    """The fit stores bf16-mode points as bf16; the score rounds f32 points
    to bf16 anyway, so both inputs give the same assignment and sums."""
    p, c, _ = _inputs(22)
    tp, tc = torch.from_numpy(p), torch.from_numpy(c)
    a = fused_assign_sum(tp, tc, K, "bf16")
    b = fused_assign_sum(tp.to(torch.bfloat16), tc, K, "bf16")
    assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="highest"):
        fused_assign_sum(tp.to(torch.bfloat16), tc, K, "highest")


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU takes no plain version: a device
    without a kernel raises (a CUDA tensor launches the kernel or raises)."""
    p = torch.empty((N, D), device="meta")
    c = torch.empty((K, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_assign_sum(p, c, K)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_fit_device_matches_jax(precision):
    pts = _blobs(23)
    init = pts[:5].copy()
    got = tkm.kmeans_fit_device(pts, init, iters=3, device="cpu",
                                precision=precision)
    want = jkm.kmeans_fit_device(pts, init, iters=3, precision=precision)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if precision == "highest":
        oracle = init
        for _ in range(3):
            oracle = tkm.kmeans_model(pts, oracle)
        np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=0)


def test_run_job_kmeans_matches_jax(tmp_path):
    pts = _blobs(24, n=3000, d=6, k=4)
    inp = tmp_path / "pts.npy"
    np.save(inp, pts)
    out_t, out_j = tmp_path / "t.npy", tmp_path / "j.npy"
    timings_keys = {"time/transfer_s", "time/iter_s"}
    r = run_job(JobConfig(input_path=str(inp), output_path=str(out_t),
                          backend="cpu", kmeans_k=4, kmeans_iters=4,
                          metrics=False), "kmeans")
    assert timings_keys <= set(r.metrics)
    j = jax_run_job(JaxJobConfig(input_path=str(inp), output_path=str(out_j),
                                 backend="cpu", num_shards=1, kmeans_k=4,
                                 kmeans_iters=4, metrics=False), "kmeans")
    np.testing.assert_allclose(r.centroids, j.centroids, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.load(out_t), np.load(out_j), atol=1e-4,
                               rtol=0)
