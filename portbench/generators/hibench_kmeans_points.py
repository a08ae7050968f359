"""Points for HiBench's KMeans workload: a seeded Gaussian mixture of real
numbers, standing in for the samples of HiBench's ``GenKMeansDataset``.

Reads the configuration's ``dataset`` section:

- ``n``, ``d``: the number of points and their width;
- ``components``: mixture components (HiBench's ``num_of_clusters``),
  drawn with equal weight;
- ``center_min``, ``center_max``: each centre coordinate is uniform on
  [center_min, center_max);
- ``spread``: the standard deviation of a point around its centre, the
  same in every coordinate;
- ``block_rows``: rows made per device call.

Coordinates are not rounded, and are stored as float32.  The draws run on
``device`` from one ``torch.Generator`` seeded with the run's seed, so a
seed gives the same bytes on the same kind of device.  Each point's
component is drawn independently, so the first ``k`` points are a uniform
random sample (HiBench's ``initializationmode`` Random).  The points are
written as a ``.npy`` file in ``out_dir`` and synced to disk.
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


def centers(spec: dict, g: torch.Generator, device: str) -> torch.Tensor:
    """The ``(components, d)`` mixture centres: the generator's first draw."""
    lo, hi = float(spec["center_min"]), float(spec["center_max"])
    c = torch.rand((int(spec["components"]), int(spec["d"])), generator=g,
                   device=device)
    return c.mul_(hi - lo).add_(lo)


def generate(spec: dict, seed: int, out_dir: Path, device: str) -> dict:
    n, d = int(spec["n"]), int(spec["d"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    mu = centers(spec, g, device)
    path = Path(out_dir) / "points.npy"
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(n, d))
    step = int(spec["block_rows"])
    for lo in range(0, n, step):
        m = min(step, n - lo)
        comp = torch.randint(0, mu.shape[0], (m,), generator=g,
                             device=device)
        x = torch.randn((m, d), generator=g, device=device)
        x.mul_(float(spec["spread"])).add_(mu[comp])
        out[lo:lo + m] = x.cpu().numpy()
    out.flush()
    del out
    _sync(path)
    return {"path": str(path), "bytes": path.stat().st_size, "n": n, "d": d}
