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
    fused_assign_sum,
    fused_assign_sum_plain,
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


# (n, d, k): ragged tails, k off the 128-centroid chunk, a d whose partial
# does not fit shared memory at k=2048, one-row and tiny inputs
SHAPES = [(2048 + 777, 16, 32), (1000, 64, 200), (5000, 64, 2048),
          (300, 130, 7), (1, 3, 1), (129, 1, 5)]


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


def test_kernel_is_deterministic_and_refuses_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    p = torch.randn(50_000, 64, generator=g, device=cuda)
    c = torch.randn(300, 64, generator=g, device=cuda)
    a = fused_assign_sum(p, c, 300)
    b = fused_assign_sum(p, c, 300)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(RuntimeError, match="launch failed"):
        wide = torch.randn(10, 400, device=cuda)
        fused_assign_sum(wide, wide[:2].contiguous(), 2)
    with pytest.raises(ValueError, match="centroids"):
        fused_assign_sum(p, c.double(), 300)


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
