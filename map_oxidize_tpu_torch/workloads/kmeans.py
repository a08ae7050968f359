"""k-means with the points resident in device memory.

MapReduce formulation, as in the JAX package:

    map:    point -> (nearest centroid id, [x_0..x_{d-1}, 1])
    reduce: per-key vector sum
    emit:   new centroid c_k = sum_k[:d] / sum_k[d]

:func:`kmeans_fit_device` puts the points on the device ONCE and runs every
iteration there; each iteration is one call of the fused assign + sum
(:func:`~map_oxidize_tpu_torch.ops.kmeans_kernel.fused_assign_sum`: the
hand-written CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor) and a centroid update.  Only the final ``(k, d)`` centroids cross
back.  Input convention: a ``.npy`` file of float32 ``(n, d)`` points.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from map_oxidize_tpu_torch.ops.kmeans_kernel import (
    fused_assign_sum,
    fused_assign_sum_plain as assign_and_sum,
)

__all__ = ["assign_and_sum", "assign_points", "kmeans_fit_device",
           "kmeans_model", "write_centroids"]


def assign_points(points: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid ids, vectorized: argmin_k ||p||^2 - 2 p.C^T + ||c||^2
    (the ||p||^2 term is constant per point and dropped)."""
    d2 = -2.0 * points @ centroids.T + (centroids * centroids).sum(1)
    return np.argmin(d2, axis=1).astype(np.int32)


def kmeans_model(points: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """NumPy oracle: one full-batch iteration (independent of the engine)."""
    points = np.asarray(points, np.float32)
    centroids = np.asarray(centroids, np.float32)
    cid = assign_points(points, centroids)
    new = centroids.copy()
    for k in range(centroids.shape[0]):
        m = cid == k
        if m.any():
            new[k] = points[m].mean(0)
    return new


def _kmeans_step_impl(c, p, k: int, precision: str = "highest"):
    """One iteration: assign + sum, then move every non-empty centroid to
    its mean (an empty centroid keeps its position)."""
    sums, counts = fused_assign_sum(p, c, k, precision)
    return torch.where(counts[:, None] > 0,
                       sums / counts.clamp_min(1.0)[:, None], c)


def kmeans_fit_device(points, centroids, iters: int = 1, device=None,
                      on_iter=None, timings: dict | None = None,
                      precision: str = "highest") -> np.ndarray:
    """Device-resident k-means: the points transfer once, ``iters``
    iterations run on ``device``, and the final centroids return as NumPy.

    In ``bf16`` mode the points are stored as bf16 on the device: every
    iteration re-reads the whole array and the score product rounds them to
    bf16 anyway, so the numerics are unchanged and the bytes halve.

    ``on_iter(i, centroids_np)`` sees the state after each iteration (one
    ``(k, d)`` fetch per iteration).  ``timings`` (when a dict is passed)
    receives ``transfer_s`` (host->device copy of the points) and
    ``iter_s`` (the whole iteration chain, synchronised, ``on_iter``'s
    calls included)."""
    if device is None:
        from map_oxidize_tpu_torch.runtime.engine import pick_device

        device = pick_device("cuda")
    device = torch.device(device)
    # a copy: the caller's array may be a read-only memory map
    points = torch.from_numpy(np.array(points, np.float32))
    if precision == "bf16":
        points = points.to(torch.bfloat16)  # round to nearest even
    c = torch.from_numpy(np.array(centroids, np.float32)).to(device)
    k = c.shape[0]

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    p = points.to(device)
    _sync()
    if timings is not None:
        timings["transfer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(iters):
        c = _kmeans_step_impl(c, p, k, precision)
        if on_iter is not None:
            on_iter(i + 1, c.cpu().numpy())
    out = c.cpu().numpy()
    if timings is not None:
        timings["iter_s"] = time.perf_counter() - t0
    return out


def write_centroids(path: str, centroids: np.ndarray) -> None:
    """Atomic centroid writer: writes the EXACT configured path
    (``np.save(str)`` would append '.npy'), temp + rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, np.asarray(centroids, np.float32))
    os.replace(tmp, path)
