"""How fast the resident k-means transfer reads a points file, by reader
thread count: the read of a ``.npy`` straight into pinned 32 MiB blocks
(``os.preadv`` split over 1, 2, 4, 6 and 8 threads, the loop of
``workloads/kmeans.py`` ``_resident_points`` without its copies), the
whole transfer to the card at each count, and the route it replaced
(``np.array`` out of the memory map, then ``.to(device)``).

The files have the shapes of the two k-means benchmark cells (20M x 20 and
1M x 128 float32), written to a temporary directory and read from the page
cache, as the benchmark's jobs read them.  Needs one CUDA card:

    python3 scripts/kmeans_read_probe.py

Prints the card's name and power limit, then one JSON line per reading:
the median of five rounds in ms and the GB/s it gives.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from map_oxidize_tpu_torch.workloads import kmeans as tkm  # noqa: E402

SHAPES = {"hibench-large": (20_000_000, 20), "sift1m": (1_000_000, 128)}
THREADS = (1, 2, 4, 6, 8)
ROUNDS = 5


def _write(path: str, n: int, d: int) -> None:
    rng = np.random.default_rng(0)
    out = np.lib.format.open_memmap(path, "w+", np.float32, (n, d))
    for lo in range(0, n, 1 << 20):
        hi = min(lo + (1 << 20), n)
        out[lo:hi] = rng.random((hi - lo, d), dtype=np.float32)
    out.flush()
    del out


def _median_ms(fn) -> float:
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _read_only(mm, threads: int) -> None:
    """The block loop's reads alone, into three pinned slots."""
    n, d = mm.shape
    rows = tkm._BLOCK_BYTES // (4 * d)
    slots = [torch.empty((rows, d), dtype=torch.float32, pin_memory=True)
             for _ in range(3)]
    fd = os.open(mm.filename, os.O_RDONLY)
    try:
        with ThreadPoolExecutor(threads) as pool:
            for b, lo in enumerate(range(0, n, rows)):
                hi = min(lo + rows, n)
                tkm._read_block(pool, fd, mm.offset + lo * 4 * d,
                                slots[b % 3][:hi - lo].numpy())
    finally:
        os.close(fd)


def _old_route(mm, device) -> None:
    torch.from_numpy(np.array(mm, np.float32)).to(device)
    torch.cuda.synchronize(device)


def _transfer(mm, device) -> None:
    tkm._resident_points(mm, device, torch.float32, tkm._no_step)


def _line(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main() -> None:
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _line(cpus=os.cpu_count(), affinity=len(os.sched_getaffinity(0)))
    with tempfile.TemporaryDirectory() as tmp:
        for name, (n, d) in SHAPES.items():
            path = os.path.join(tmp, f"{name}.npy")
            _write(path, n, d)
            mm = np.load(path, mmap_mode="r")
            gb = n * d * 4 / 1e9
            _transfer(mm, device)  # the pinned slots' first allocation
            ms = _median_ms(lambda: _old_route(mm, device))
            _line(shape=name, route="np.array + .to", ms=round(ms, 2),
                  gb_s=round(gb / ms * 1e3, 3))
            for threads in THREADS:
                tkm._READ_THREADS = threads  # the parts of a block
                ms = _median_ms(lambda: _read_only(mm, threads))
                _line(shape=name, route="read into pinned", threads=threads,
                      ms=round(ms, 2), gb_s=round(gb / ms * 1e3, 3))
                ms = _median_ms(lambda: _transfer(mm, device))
                _line(shape=name, route="transfer", threads=threads,
                      ms=round(ms, 2), gb_s=round(gb / ms * 1e3, 3))
            del mm
            os.unlink(path)


if __name__ == "__main__":
    main()
