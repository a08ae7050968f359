"""The resident k-means transfer on the CPU: the points reach ``p`` in
blocks of whole rows, read straight from a ``.npy`` file's memory map
(``os.preadv`` over a pool of threads) or copied from any other array with
``np.copyto``.  The block size shrinks through its module constant, so a
small file spans more blocks than the ring has slots and ends in a short
block.  Either fill gives the bits of the route it replaced
(``np.array(points, np.float32)``, then the bf16 rounding), so every
centroid is bit-identical, and ``kmeans/read_blocks`` counts the blocks read
from the file.  The card's form of the same checks is in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.workloads import kmeans as tkm

torch.set_num_threads(2)

N, D, K, ITERS = 3000, 6, 4, 3
#: 401 rows a block: 8 blocks over 3 slots, the last of 193 rows; a block
#: of 9,624 bytes splits into three page-multiple reads, mid-row
BLOCK_ROWS = 401
BLOCKS = -(-N // BLOCK_ROWS)
PRECISIONS = ["highest", "bf16"]


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(tkm, "_BLOCK_BYTES", BLOCK_ROWS * 4 * D)


def _points(seed=11, n=N, d=D):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(K, d))
    pts = centres[rng.integers(0, K, size=n)] + rng.normal(0, 0.7, (n, d))
    pts[:K] = centres
    return pts.astype(np.float32)


def _old_route(points, precision):
    """The points as the resident fit held them before the block loop."""
    p = torch.from_numpy(np.array(points, np.float32))
    return p.to(torch.bfloat16) if precision == "bf16" else p


def _old_fit(points, precision, iters=ITERS):
    p = _old_route(points, precision)
    c = torch.from_numpy(np.array(points[:K], np.float32))
    return tkm._kmeans_fit(c, p, K, iters, precision).numpy()


def _bits(t: torch.Tensor) -> bytes:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy().tobytes()


def _resident(points, precision):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return tkm._resident_points(points, torch.device("cpu"), dtype,
                                tkm._no_step)


@pytest.mark.parametrize("threads", [1, 4, 8])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_a_npy_map_reads_from_the_file_bit_identical(tmp_path, monkeypatch,
                                                      precision, threads):
    monkeypatch.setattr(tkm, "_READ_THREADS", threads)
    pts = _points()
    np.save(tmp_path / "p.npy", pts)
    mm = np.load(tmp_path / "p.npy", mmap_mode="r")
    p, blocks = _resident(mm, precision)
    assert blocks == BLOCKS
    assert p.dtype == _old_route(pts, precision).dtype
    assert _bits(p) == _bits(_old_route(pts, precision))
    got = tkm.kmeans_fit_device(mm, pts[:K], iters=ITERS, device="cpu",
                                precision=precision)
    assert got.tobytes() == _old_fit(pts, precision).tobytes()


def _sliced_map(path, pts):
    return np.load(path, mmap_mode="r")[1:], pts[1:]


def _copy_on_write_map(path, pts):
    mm = np.load(path, mmap_mode="c")
    mm[5] = 7.0  # the file does not see this write
    want = pts.copy()
    want[5] = 7.0
    return mm, want


def _fortran_map(path, pts):
    np.save(path, np.asfortranarray(pts))
    return np.load(path, mmap_mode="r"), pts


def _float64_map(path, pts):
    np.save(path, pts.astype(np.float64))
    return np.load(path, mmap_mode="r"), pts.astype(np.float64)


FILLS = {
    "sliced_map": _sliced_map,
    "copy_on_write_map": _copy_on_write_map,
    "fortran_map": _fortran_map,
    "float64_map": _float64_map,
    "in_memory": lambda path, pts: (pts.copy(), pts),
    "float64": lambda path, pts: (pts.astype(np.float64),) * 2,
    "fortran": lambda path, pts: (np.asfortranarray(pts), pts),
    "list": lambda path, pts: (pts[:50].tolist(), pts[:50]),
}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("fill", sorted(FILLS))
def test_any_other_array_is_copied_with_the_old_cast(tmp_path, fill,
                                                     precision):
    path = tmp_path / "p.npy"
    pts = _points()
    np.save(path, pts)
    points, want = FILLS[fill](path, pts)
    p, blocks = _resident(points, precision)
    assert blocks == 0
    assert _bits(p) == _bits(_old_route(want, precision))
    got = tkm.kmeans_fit_device(points, want[:K], iters=ITERS, device="cpu",
                                precision=precision)
    assert got.tobytes() == _old_fit(want, precision).tobytes()


def _job(path, precision, **kw):
    return run_job(JobConfig(input_path=str(path), backend="cpu",
                             mapper="device", kmeans_k=K, kmeans_iters=ITERS,
                             kmeans_precision=precision, output_path="",
                             metrics=False, **kw), "kmeans")


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("layout", ["npy", "fortran", "float64"])
def test_a_job_counts_the_blocks_read_from_its_file(tmp_path, layout,
                                                    precision):
    """``kmeans/read_blocks`` is in every resident job's metrics: the block
    count where the file's map is read, 0 where ``np.copyto`` filled."""
    pts = _points()
    path = tmp_path / "p.npy"
    src = {"npy": pts, "fortran": np.asfortranarray(pts),
           "float64": pts.astype(np.float64)}[layout]
    np.save(path, src)
    res = _job(path, precision, trace_out="-")
    assert res.metrics["kmeans/read_blocks"] == (BLOCKS if layout == "npy"
                                                 else 0)
    assert res.centroids.tobytes() == _old_fit(src, precision).tobytes()
    (read,) = [e for e in res.trace if e.get("ph") == "X"
               and e["name"] == "kmeans/read_points"]
    assert read["args"]["bytes"] == N * D * (2 if precision == "bf16" else 4)


def test_one_block_and_an_empty_file(tmp_path, monkeypatch):
    """A file under one block is one read; no rows are no read."""
    monkeypatch.setattr(tkm, "_BLOCK_BYTES", 1 << 20)
    pts = _points(n=700)
    np.save(tmp_path / "p.npy", pts)
    p, blocks = _resident(np.load(tmp_path / "p.npy", mmap_mode="r"),
                          "highest")
    assert blocks == 1 and _bits(p) == _bits(_old_route(pts, "highest"))
    np.save(tmp_path / "e.npy", np.empty((0, D), np.float32))
    p, blocks = _resident(np.load(tmp_path / "e.npy", mmap_mode="r"),
                          "highest")
    assert blocks == 0 and tuple(p.shape) == (0, D)
