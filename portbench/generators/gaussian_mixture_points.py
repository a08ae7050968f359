"""Points for a k-means job: a seeded Gaussian mixture, rounded to integers.

Reads the configuration's ``dataset`` section:

- ``n``, ``d``: the number of points and their width;
- ``components``: mixture components, drawn with equal weight;
- ``center_max``, ``center_power``: each centre coordinate is
  ``center_max * u ** center_power`` with ``u`` uniform on [0, 1), so most
  coordinates are small and a few large, as in SIFT descriptors;
- ``spread``: the standard deviation of a point around its centre;
- ``value_min``, ``value_max``: every coordinate is rounded to an integer
  and clipped to this range, then stored as float32;
- ``block_rows``: rows made per device call.

The draws run on ``device`` from one ``torch.Generator`` seeded with the
run's seed, so a seed gives the same bytes on the same kind of device.  The
points are written as a ``.npy`` file in ``out_dir`` and synced to disk.
Points are drawn independently, so the first ``k`` of them are a uniform
random sample.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch


def _sync(path: Path) -> None:
    """Write the file back to disk now, in set-up, and not while the
    window runs."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def generate(spec: dict, seed: int, out_dir: Path, device: str) -> dict:
    n, d = int(spec["n"]), int(spec["d"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    centers = torch.rand((int(spec["components"]), d), generator=g,
                         device=device)
    centers.pow_(float(spec["center_power"])).mul_(float(spec["center_max"]))
    path = Path(out_dir) / "points.npy"
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(n, d))
    step = int(spec["block_rows"])
    for lo in range(0, n, step):
        m = min(step, n - lo)
        comp = torch.randint(0, centers.shape[0], (m,), generator=g,
                             device=device)
        x = torch.randn((m, d), generator=g, device=device)
        x.mul_(float(spec["spread"])).add_(centers[comp])
        x.round_().clamp_(float(spec["value_min"]), float(spec["value_max"]))
        x.add_(0.0)  # -0.0 -> 0.0: one bit pattern per value
        out[lo:lo + m] = x.cpu().numpy()
    out.flush()
    del out
    _sync(path)
    return {"path": str(path), "bytes": path.stat().st_size, "n": n, "d": d}
