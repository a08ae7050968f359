"""Tests of the port that need a CUDA card: the hand-written kernel against
its plain version, and the fold on the card against the fold on the CPU.
They skip without a card.  On a card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.ops.kmeans_kernel import (
    TILE_N,
    fused_assign_sum,
    fused_assign_sum_plain,
    plan,
)
from map_oxidize_tpu_torch.runtime import run_job

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the largest k at d=64 whose centroids stay resident in shared memory, and
# the next k, which streams them, per mode
RESIDENT_EDGE = {"highest": (512, 513), "bf16": (1280, 1281)}

# (n, d, k): ragged tails, k off the centroid chunk, a d whose partial
# does not fit shared memory at k=2048, one-row and tiny inputs; bf16 rows
# that are not whole 16-byte units while f32 rows are (d=20); k on both
# sides of the resident limit; k off the mma N-tile of 8; n under one tile
# and n an exact multiple of the tile
SHAPES = [(2048 + 777, 16, 32), (1000, 64, 200), (5000, 64, 2048),
          (300, 130, 7), (1, 3, 1), (129, 1, 5),
          (3000, 20, 64), (700, 64, 512), (700, 64, 513), (700, 64, 1280),
          (700, 64, 1281), (2000, 64, 1000), (50, 64, 256),
          (20 * TILE_N, 64, 256)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_kernel_matches_plain_exactly_on_integer_inputs(cuda, precision,
                                                        shape):
    """Integer inputs make every score, sum and count exact in f32 and bf16
    and make ties common: kernel and plain version agree bit for bit, the
    lowest index winning every tie."""
    n, d, k = shape
    g = torch.Generator(device=cuda).manual_seed(n * 131 + d * 7 + k)
    p = torch.randint(-3, 4, (n, d), generator=g, device=cuda).float()
    c = torch.randint(-3, 4, (k, d), generator=g, device=cuda).float()
    w = (torch.rand(n, generator=g, device=cuda) > 0.3).float()
    inputs = [p] + ([p.to(torch.bfloat16)] if precision == "bf16" else [])
    before = fused_assign_sum.launches
    for pp in inputs:
        for wt in (None, w):
            s1, c1 = fused_assign_sum(pp, c, k, precision, w=wt)
            s2, c2 = fused_assign_sum_plain(pp, c, k, precision, w=wt)
            torch.cuda.synchronize()
            assert torch.equal(c1, c2)
            assert torch.equal(s1, s2)
    assert fused_assign_sum.launches == before + 2 * len(inputs)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_kernel_matches_plain_on_normal_inputs(cuda, precision):
    """Random normal data at a small size (no near-ties): counts equal,
    sums within rtol 1e-5 / atol 1e-4, the CPU tests' bound."""
    rng = np.random.default_rng(41)
    p = torch.from_numpy(rng.normal(size=(2048 + 777, 16)).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)).to(cuda)
    s1, c1 = fused_assign_sum(p, c, 32, precision)
    s2, c2 = fused_assign_sum_plain(p, c, 32, precision)
    assert torch.equal(c1, c2)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_resident_limit_sits_between_the_tested_k(cuda, precision):
    """The SHAPES cases at RESIDENT_EDGE run both centroid paths."""
    lo, hi = RESIDENT_EDGE[precision]
    index = torch.cuda.current_device()
    bf16 = precision == "bf16"
    assert plan(index, bf16, bf16, 700, 64, lo)["resident"]
    assert not plan(index, bf16, bf16, 700, 64, hi)["resident"]


@pytest.mark.parametrize("precision,k", [("highest", 300), ("highest", 2048),
                                         ("bf16", 300), ("bf16", 2048)])
def test_kernel_is_deterministic_and_refuses_what_it_cannot_take(
        cuda, precision, k):
    g = torch.Generator(device=cuda).manual_seed(5)
    p = torch.randn(50_000, 64, generator=g, device=cuda)
    c = torch.randn(k, 64, generator=g, device=cuda)
    if precision == "bf16":
        p = p.to(torch.bfloat16)
    a = fused_assign_sum(p, c, k, precision)
    b = fused_assign_sum(p, c, k, precision)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(RuntimeError, match="launch failed"):
        wide = torch.randn(10, 400, device=cuda)
        fused_assign_sum(wide, wide[:2].contiguous(), 2)
    with pytest.raises(ValueError, match="centroids"):
        fused_assign_sum(p, c.double(), k, precision)


def test_wordcount_and_kmeans_on_the_card_match_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(42)
    words = np.array([b"w%d" % i for i in range(3000)])
    text = b" ".join(words[rng.zipf(1.2, size=60_000) % 3000]) + b"\n"
    inp = tmp_path / "c.txt"
    inp.write_bytes(text)
    outs = {}
    for backend in ("cuda", "cpu"):
        out = tmp_path / f"{backend}.txt"
        r = run_job(JobConfig(input_path=str(inp), output_path=str(out),
                              backend=backend, batch_size=1024,
                              initial_key_capacity=256, metrics=False))
        assert r.metrics["accumulator_device"].startswith(backend)
        outs[backend] = (out.read_bytes(), r.top)
    assert outs["cuda"] == outs["cpu"]

    centres = rng.normal(0, 10, size=(16, 8)).astype(np.float32)
    pts = (centres[rng.integers(0, 16, size=20_000)]
           + rng.normal(0, 0.5, size=(20_000, 8))).astype(np.float32)
    pts[:16] = centres
    np.save(tmp_path / "p.npy", pts)
    cents = {}
    for backend in ("cuda", "cpu"):
        cents[backend] = run_job(JobConfig(
            input_path=str(tmp_path / "p.npy"), output_path="",
            backend=backend, kmeans_k=16, kmeans_iters=3,
            metrics=False), "kmeans").centroids
    np.testing.assert_allclose(cents["cuda"], cents["cpu"], atol=1e-3)


def test_native_wordcount_on_the_card_matches_the_python_map(cuda, tmp_path):
    """mapper='auto' (the C++ scan in the prefetch thread, the fold on the
    card) against mapper='python': the same bytes and top-k."""
    from map_oxidize_tpu_torch.runtime import resolve_mapper

    rng = np.random.default_rng(43)
    words = np.array([b"W%d" % i for i in range(5000)])
    text = b"\n".join(b" ".join(words[rng.zipf(1.2, size=40) % 5000])
                      for _ in range(3000)) + b"\n"
    inp = tmp_path / "c.txt"
    inp.write_bytes(text)
    outs = {}
    for mapper in ("auto", "python"):
        out = tmp_path / f"{mapper}.txt"
        cfg = JobConfig(input_path=str(inp), output_path=str(out),
                        chunk_bytes=64 << 10, batch_size=4096,
                        initial_key_capacity=256, mapper=mapper,
                        metrics=False)
        r = run_job(cfg)
        assert r.metrics["accumulator_device"].startswith("cuda")
        outs[resolve_mapper(cfg, "wordcount")] = (out.read_bytes(), r.top)
    assert set(outs) == {"native", "python"}
    assert outs["native"] == outs["python"]


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_kmeans_kill_and_resume_on_the_card_is_bit_equal(cuda, tmp_path,
                                                         monkeypatch,
                                                         precision):
    """Killed by ``on_iter`` after 4 of 10 iterations, resumed from the
    snapshot: bit-equal to an uninterrupted fit, and the resumed run
    launches the kernel once per remaining iteration."""
    import os

    from map_oxidize_tpu_torch.workloads import kmeans as tkm

    rng = np.random.default_rng(44)
    centres = rng.normal(0, 2, size=(64, 32)).astype(np.float32)
    pts = (centres[rng.integers(0, 64, size=200_000)]
           + rng.normal(0, 1.0, size=(200_000, 32))).astype(np.float32)
    np.save(tmp_path / "p.npy", pts)

    def cfg(ck):
        return JobConfig(input_path=str(tmp_path / "p.npy"), output_path="",
                         kmeans_k=64, kmeans_iters=10, checkpoint_dir=ck,
                         kmeans_precision=precision, metrics=False)

    want = run_job(cfg(None), "kmeans").centroids
    real = tkm.kmeans_fit_device

    def dying(*a, on_iter=None, **kw):
        def hook(i, c):
            on_iter(i, c)
            if i == 4:
                raise KeyboardInterrupt("simulated kill")
        return real(*a, on_iter=hook, **kw)

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(tkm, "kmeans_fit_device", dying)
    with pytest.raises(KeyboardInterrupt):
        run_job(cfg(ck), "kmeans")
    monkeypatch.setattr(tkm, "kmeans_fit_device", real)
    fused_assign_sum.launches = 0
    res = run_job(cfg(ck), "kmeans")
    assert fused_assign_sum.launches == 6
    assert res.metrics["resumed_iters"] == 4
    assert res.centroids.tobytes() == want.tobytes()
    assert not os.path.isdir(ck)
