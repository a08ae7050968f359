"""Plain reference for a k-means job, and the comparison that judges one.

Lloyd's algorithm as the configuration states it: the first ``k`` points
are the initial centroids; each iteration assigns every point to its
nearest centroid (the first on a tie) and moves every centroid that got
points to their mean, an empty one staying where it was.  The reference
computes in float64 on ``device``, in blocks of rows.  It reads the
points file the job was given and nothing that the program made.

The control is the same algorithm with its score product in TF32, the
precision below the configuration's float32: on a card PyTorch's own TF32
matmul, on the CPU the operands rounded to TF32's 10 mantissa bits.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

BLOCK_ROWS = 1 << 16


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _scores(p: torch.Tensor, c: torch.Tensor, mode: str) -> torch.Tensor:
    """``|c|^2 - 2 p.c`` per (point, centroid): the squared distance less
    the point's own norm, which does not change the argmin."""
    if mode == "float64":
        return (c * c).sum(1) - 2.0 * (p @ c.T)
    if p.device.type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            prod = p @ c.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    else:
        prod = _round_tf32(p) @ _round_tf32(c).T
    return (c * c).sum(1) - 2.0 * prod


def fit(points_path: str, k: int, iters: int, device: str,
        mode: str = "float64") -> np.ndarray:
    """The centroids after ``iters`` iterations, as float64 (``mode``
    'float64', the reference) or float32 (``mode`` 'tf32', the control)."""
    if mode not in ("float64", "tf32"):
        raise ValueError(f"unknown mode {mode!r}")
    dtype = torch.float64 if mode == "float64" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    pts = np.load(points_path, mmap_mode="r")
    p = torch.from_numpy(np.array(pts)).to(device, dtype)
    n, d = p.shape
    c = p[:k].clone()
    ones = torch.ones(BLOCK_ROWS, dtype=dtype, device=device)
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=dtype, device=device)
        counts = torch.zeros(k, dtype=dtype, device=device)
        for lo in range(0, n, BLOCK_ROWS):
            blk = p[lo:lo + BLOCK_ROWS]
            cid = torch.argmin(_scores(blk, c, mode), dim=1)
            sums.index_add_(0, cid, blk)
            counts.index_add_(0, cid, ones[:blk.shape[0]])
        c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1.0)[:, None], c)
    return c.cpu().numpy()


def assignments(points_path: str, centroids: np.ndarray,
                device: str) -> torch.Tensor:
    """Each point's nearest centroid in float64 (the first on a tie)."""
    pts = np.load(points_path, mmap_mode="r")
    c = torch.from_numpy(np.asarray(centroids, np.float64)).to(device)
    out = []
    for lo in range(0, pts.shape[0], BLOCK_ROWS):
        blk = torch.from_numpy(np.asarray(pts[lo:lo + BLOCK_ROWS],
                                          np.float64)).to(device)
        out.append(torch.argmin(_scores(blk, c, "float64"), dim=1))
    return torch.cat(out)


#: a centroid has moved when its distance from the reference's, over the
#: median length of the reference's centroids, exceeds this (the float32
#: rounding of a mean reads 2.5e-8 to 3.9e-8 of it)
MOVED = 1e-6


def numbers(answer: np.ndarray, ref: np.ndarray, points_path: str,
            ref_assign: torch.Tensor, device: str) -> dict:
    """How far one centroid table lies from the reference's:

    - ``centroids_moved``: the share of centroids that have moved (see
      :data:`MOVED`);
    - ``centroid_gap_max``: the largest distance between a centroid and the
      reference's, over the median length of the reference's centroids;
    - ``assign_mismatch``: the share of points whose nearest centroid under
      the answer is another index than under the reference.
    An answer of the wrong shape, or with a value that is not finite, reads
    as far as can be."""
    answer = np.asarray(answer, np.float64)
    if answer.shape != ref.shape or not np.isfinite(answer).all():
        return {"centroids_moved": 1.0, "centroid_gap_max": float("inf"),
                "assign_mismatch": 1.0}
    scale = float(np.median(np.linalg.norm(ref, axis=1)))
    gap = np.linalg.norm(answer - ref, axis=1) / scale
    got = assignments(points_path, answer, device)
    return {"centroids_moved": float((gap > MOVED).mean()),
            "centroid_gap_max": float(gap.max()),
            "assign_mismatch": float((got != ref_assign).double().mean())}


def expected(cfg: dict, dataset: dict, device: str):
    """The reference's answer: its centroids and each point's nearest."""
    params = cfg["job_params"]
    ref = fit(dataset["path"], int(params["kmeans_k"]),
              int(params["kmeans_iters"]), device)
    return ref, assignments(dataset["path"], ref, device)


def judge(cfg: dict, dataset: dict, want, outputs: list[Path],
          device: str) -> dict:
    """The worst reading over the written centroid files ``outputs`` (one
    per job; identical files are read once) against ``want``."""
    ref, ref_assign = want
    worst: dict = {}
    seen: set[bytes] = set()
    for path in outputs:
        path = Path(path)
        raw = path.read_bytes() if path.is_file() else b""
        if raw in seen:
            continue
        seen.add(raw)
        try:
            answer = np.load(path)
        except (OSError, ValueError):  # missing or malformed
            answer = np.full(1, np.nan)
        for name, v in numbers(answer, ref, dataset["path"], ref_assign,
                               device).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def check(cfg: dict, dataset: dict, outputs: list[Path],
          device: str) -> dict:
    return judge(cfg, dataset, expected(cfg, dataset, device), outputs,
                 device)


def control_outputs(cfg: dict, dataset: dict, out_dir: Path,
                    device: str) -> list[Path]:
    """The control's answer, written where a job writes its own."""
    params = cfg["job_params"]
    c = fit(dataset["path"], int(params["kmeans_k"]),
            int(params["kmeans_iters"]), device, mode="tf32")
    path = Path(out_dir) / cfg["output"]
    np.save(path, c.astype(np.float32))
    return [path]
