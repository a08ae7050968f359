"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain versions, the fold on the card against the fold on the
CPU, the streamed k-means through the pinned staging ring, the
observability seams on the card (device memory, the profiler trace,
determinism), the collect route, the device mapper and the dataflow card
sort against the CPU and the host.
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


# --- the streamed k-means ---------------------------------------------------


def _int_points(seed, n, d, k):
    """Integer points (exact in f32 and bf16, every sum exact) in clusters
    20 apart: every streamed schedule and the CPU give the same bits."""
    rng = np.random.default_rng(seed)
    centres = 20 * rng.integers(-2, 3, size=(k, d))
    centres[:, 0] = 20 * np.arange(k) - 20 * (k // 2)
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.integers(-3, 4, size=(n, d))).astype(np.float32)
    pts[:k] = centres
    return pts


def test_stream_device_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``mapper='auto'`` past a tiny fit budget streams through the card:
    ``kmeans_mode`` says so, the kernel launches once per chunk per
    iteration, and the centroids are within atol 1e-3 of the CPU backend's
    (the sums add in another order), in both precisions."""
    from map_oxidize_tpu_torch.workloads.kmeans import kmeans_model

    rng = np.random.default_rng(45)
    centres = rng.normal(0, 10, size=(16, 8)).astype(np.float32)
    pts = (centres[rng.integers(0, 16, size=20_000)]
           + rng.normal(0, 0.5, size=(20_000, 8))).astype(np.float32)
    pts[:16] = centres
    np.save(tmp_path / "p.npy", pts)
    chunk_rows = 4096 // (4 * (8 + 2 * 16))
    n_chunks = -(-20_000 // chunk_rows)
    for precision in ("highest", "bf16"):
        cents = {}
        for backend in ("cuda", "cpu"):
            fused_assign_sum.launches = 0
            r = run_job(JobConfig(
                input_path=str(tmp_path / "p.npy"), output_path="",
                backend=backend, kmeans_k=16, kmeans_iters=3,
                chunk_bytes=4096, kmeans_device_fit_bytes=64,
                kmeans_precision=precision, metrics=False), "kmeans")
            assert r.metrics["kmeans_mode"] == "stream_device"
            assert r.metrics["device"].startswith(backend)
            assert fused_assign_sum.launches == (
                3 * n_chunks if backend == "cuda" else 0)
            cents[backend] = r.centroids
        np.testing.assert_allclose(cents["cuda"], cents["cpu"], atol=1e-3)
        if precision == "highest":
            want = pts[:16]
            for _ in range(3):
                want = kmeans_model(pts, want)
            np.testing.assert_allclose(cents["cuda"], want, atol=1e-3)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_stream_device_is_bit_identical_across_b_and_depth(cuda, tmp_path,
                                                           precision):
    """Integer inputs, 29 chunks with a ragged tail: every B and depth gives
    the CPU backend's bits, and the ring stages through pinned memory."""
    from map_oxidize_tpu_torch.runtime.pipeline import StagingRing
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_streamed_device,
    )

    pts = _int_points(46, 20_003, 16, 8)
    path = str(tmp_path / "p.npy")
    np.save(path, pts)
    kw = dict(iters=3, chunk_rows=700, precision=precision)
    want = kmeans_fit_streamed_device(path, pts[:8], device="cpu", **kw)
    for batch in (1, 2, 3, 7):
        for depth in (1, 2, 3):
            got = kmeans_fit_streamed_device(path, pts[:8], device=cuda,
                                             dispatch_batch=batch,
                                             pipeline_depth=depth, **kw)
            assert got.tobytes() == want.tobytes(), (batch, depth)
    ring = StagingRing(2, 4, 16, torch.float32, cuda)
    assert ring.acquire(ring.stage(0, pts[:4])).device.type == "cuda"
    assert ring._host[0].is_pinned()


def test_many_blocks_through_the_ring_equal_one_block(cuda, tmp_path):
    """60 blocks over 3 iterations through a 3-slot ring (depth 2, B=1)
    against one block per iteration (B = every chunk): bit-identical, so no
    slot was refilled while a copy or a kernel still read it; on integer
    inputs also equal to one chunk of all the points."""
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_streamed_device,
    )

    rng = np.random.default_rng(47)
    centres = rng.normal(0, 10, size=(32, 64)).astype(np.float32)
    pts = (centres[rng.integers(0, 32, size=200_000)]
           + rng.normal(0, 1.0, size=(200_000, 64))).astype(np.float32)
    path = str(tmp_path / "p.npy")
    np.save(path, pts)
    kw = dict(iters=3, chunk_rows=10_000, device=cuda)
    fused_assign_sum.launches = 0
    many = kmeans_fit_streamed_device(path, pts[:32], pipeline_depth=2,
                                      dispatch_batch=1, **kw)
    assert fused_assign_sum.launches == 60
    one = kmeans_fit_streamed_device(path, pts[:32], pipeline_depth=2,
                                     dispatch_batch=20, **kw)
    assert many.tobytes() == one.tobytes()

    ipts = _int_points(48, 200_000, 64, 32)
    np.save(path, ipts)
    many = kmeans_fit_streamed_device(path, ipts[:32], pipeline_depth=2,
                                      dispatch_batch=1, **kw)
    whole = kmeans_fit_streamed_device(path, ipts[:32], iters=3,
                                       chunk_rows=200_000, device=cuda)
    assert many.tobytes() == whole.tobytes()


def test_host_assign_stream_on_the_card_is_deterministic(cuda, tmp_path):
    """``mapper='native'`` folds the f32 partial sums on the card in a fixed
    order: two runs give the same bits, within atol 1e-4 of the CPU
    backend's."""
    rng = np.random.default_rng(49)
    centres = rng.normal(0, 10, size=(16, 8)).astype(np.float32)
    pts = (centres[rng.integers(0, 16, size=50_000)]
           + rng.normal(0, 0.5, size=(50_000, 8))).astype(np.float32)
    np.save(tmp_path / "p.npy", pts)
    cents = []
    for backend in ("cuda", "cuda", "cpu"):
        r = run_job(JobConfig(
            input_path=str(tmp_path / "p.npy"), output_path="",
            backend=backend, kmeans_k=16, kmeans_iters=3, chunk_bytes=8192,
            batch_size=512, mapper="native", metrics=False), "kmeans")
        assert r.metrics["kmeans_mode"] == "stream"
        cents.append(r.centroids)
    assert cents[0].tobytes() == cents[1].tobytes()
    np.testing.assert_allclose(cents[0], cents[2], atol=1e-4)


# --- the observability seams on the card ------------------------------------


def _blob_file(tmp_path, n=20_000, d=8, k=16, seed=47):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)
    pts[:k] = centres
    path = tmp_path / "p.npy"
    np.save(path, pts)
    return str(path)


def test_device_memory_watermarks_on_the_card(cuda, tmp_path):
    """A job on the card reports ``mem/device0_hbm_bytes`` and its peak (the
    JAX package's names), and in ``device/compute_ms`` the k-means fetch
    alone: the launch ledger's sample of the fit's one dispatch is an
    event pair, which waits for nothing."""
    r = run_job(JobConfig(input_path=_blob_file(tmp_path), output_path="",
                          backend="cuda", kmeans_k=16, kmeans_iters=2,
                          mapper="device", metrics=False), "kmeans")
    m = r.metrics
    assert m["mem/device0_hbm_peak_bytes"] >= m["mem/device0_hbm_bytes"] > 0
    assert m["device/compute_ms/count"] == 1
    assert m["xprof/kmeans/fit/dispatches"] == 1
    assert m["attrib/device_compute_ms"] > 0


def test_trace_dir_names_the_hand_written_kernel(cuda, tmp_path):
    """``trace_dir`` on the card: the ``torch.profiler`` trace records the
    kernel under its own name."""
    import json

    r = run_job(JobConfig(input_path=_blob_file(tmp_path), output_path="",
                          backend="cuda", kmeans_k=16, kmeans_iters=2,
                          mapper="device", metrics=False,
                          trace_dir=str(tmp_path / "prof")), "kmeans")
    assert r.metrics["profile/captures"] == 1
    (f,) = (tmp_path / "prof").iterdir()
    names = {e.get("name", "") for e in json.loads(f.read_text())[
        "traceEvents"]}
    assert any("kmeans_assign_sum" in n for n in names)


def test_streamed_fit_with_metrics_out_is_bit_equal_run_to_run(cuda,
                                                               tmp_path):
    """Two streamed fits with ``metrics_out`` and ``trace_out`` on: the
    centroids are bit-equal (the seams add no nondeterminism), and both
    documents report the same launches' chunk counts."""
    import json

    path = _blob_file(tmp_path)
    cents, docs = [], []
    for i in range(2):
        m = tmp_path / f"m{i}.json"
        r = run_job(JobConfig(input_path=path, output_path="",
                              backend="cuda", kmeans_k=16, kmeans_iters=3,
                              chunk_bytes=4096, kmeans_device_fit_bytes=64,
                              metrics=False, metrics_out=str(m),
                              trace_out=str(tmp_path / f"t{i}.json")),
                    "kmeans")
        assert r.metrics["kmeans_mode"] == "stream_device"
        cents.append(r.centroids)
        docs.append(json.loads(m.read_text()))
    assert cents[0].tobytes() == cents[1].tobytes()
    assert (docs[0]["counters"]["pipeline/chunks"]
            == docs[1]["counters"]["pipeline/chunks"] > 0)


def _pair_block(seed, n=1 << 16, pad=1000):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    b[0, :n // 4] |= np.uint32(0x80000000)
    b[2, n // 8:n // 2] |= np.uint32(0x80000000)
    b[:2, n // 2:n // 2 + 3000] = b[:2, :3000]
    b[:, n - pad:] = np.uint32(0xFFFFFFFF)
    return b[:, rng.permutation(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_pairs_on_the_card_matches_the_cpu(cuda, seed):
    """The collect sort's torch form (int64 order columns, two stable
    sorts) gives the same bits on the card as on the CPU, where the tests
    hold it to the JAX ``_sort_pairs``."""
    from map_oxidize_tpu_torch.runtime.collect import sort_pairs

    b = torch.from_numpy(_pair_block(seed).view(np.int32))
    torch.testing.assert_close(sort_pairs(b.to(cuda)).cpu(), sort_pairs(b),
                               rtol=0, atol=0)


def _text_corpus(path, seed=5, lines=20000):
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.2, size=(lines, 10)) % 5000
    path.write_bytes(b"\n".join(b" ".join(b"c%dX" % j for j in row)
                                for row in z) + b"\n")
    return path


def test_collect_route_on_the_card_matches_the_cpu(cuda, tmp_path):
    """bigram through the fold on the card and the collect, the inverted
    index with its pairs sorted on the card and on the host, and distinct:
    the same bytes on the card as on the CPU."""
    inp = _text_corpus(tmp_path / "c.txt")
    runs = [("bigram", {"reduce_mode": "fold", "key_capacity": 1 << 20}),
            ("bigram", {}), ("invertedindex", {"collect_sort": "device"}),
            ("invertedindex", {}), ("distinct", {})]
    for i, (wl, kw) in enumerate(runs):
        out = {}
        for backend in ("cuda", "cpu"):
            path = tmp_path / f"{i}_{backend}.txt"
            r = run_job(JobConfig(input_path=str(inp), output_path=str(path),
                                  backend=backend, chunk_bytes=64 << 10,
                                  metrics=False, **kw), wl)
            out[backend] = path.read_bytes()
        assert out["cuda"] == out["cpu"], (wl, kw)
        if kw.get("reduce_mode") == "fold":
            assert r.metrics["accumulator_device"] == "cpu"
    assert (tmp_path / "0_cuda.txt").read_bytes() == (
        tmp_path / "1_cuda.txt").read_bytes()
    assert (tmp_path / "2_cuda.txt").read_bytes() == (
        tmp_path / "3_cuda.txt").read_bytes()


def _tokenize_layout() -> dict:
    """The tokenize kernel's tile (bytes per block) and bytes per thread,
    from its source (no build needed to collect the cases)."""
    from map_oxidize_tpu_torch.ops.device_tokenize import source_layout

    return source_layout()


def _byte_chunks():
    """Padded chunks for the tokenizer: random text, all spaces, one token
    filling the window, a token at byte 0, tokens on every tile edge, a
    chunk that ends inside a token, tokens ending on a thread's or a tile's
    last byte and starting on its first, tokens longer than a tile, a row
    every other byte, ragged windows."""
    rng = np.random.default_rng(9)
    layout = _tokenize_layout()
    n, tile, per = 1 << 20, layout["tile"], layout["bytes_per_thread"]
    alphabet = np.frombuffer(b"abcdEFG,.  \n\t\x00\xff", np.uint8)
    text = rng.choice(alphabet, size=n)
    edges = np.full(n, 32, np.uint8)
    for e in range(tile, n, tile):
        edges[e - 3:e + 2] = np.frombuffer(b"TiLeX", np.uint8)
    for e in range(per, n, per * 37):
        edges[e - 1:e + 1] = np.frombuffer(b"zq", np.uint8)
    head = np.full(n, 32, np.uint8)
    head[0] = ord("A")
    tail = rng.choice(np.frombuffer(b"ab ", np.uint8), size=n)
    tail[-7:] = ord("k")
    thread_bounds = np.full(n, ord("t"), np.uint8)
    thread_bounds[per - 1:n // 2:per] = 32
    thread_bounds[n // 2::per] = 32
    tile_bounds = np.full(n, 32, np.uint8)
    for e in range(tile, n, tile):
        if e < n // 2:
            tile_bounds[e - 5:e] = np.frombuffer(b"EnDsT", np.uint8)
        else:
            tile_bounds[e:e + 5] = np.frombuffer(b"StArT", np.uint8)
    long_tokens = np.full(n, ord("L"), np.uint8)
    long_tokens[3 * tile // 2 + 7::3 * tile // 2 + 8] = 32
    dense = np.full(n, 32, np.uint8)
    dense[: n // 2:2] = ord("d")
    dense[n // 2 + 1::2] = ord("o")
    out = [("text", text), ("spaces", np.full(n, 32, np.uint8)),
           ("one token", np.full(n, ord("w"), np.uint8)),
           ("byte 0", head), ("tile edges", edges), ("ends in a token", tail),
           ("thread bounds", thread_bounds), ("tile bounds", tile_bounds),
           ("longer than a tile", long_tokens), ("row every other byte",
                                                 dense)]
    for m in (1, 15, 17, 31, 33, 4095, 4097, 8191, 8193, 12345):
        out.append((f"ragged {m}", rng.choice(alphabet, size=m)))
    return out


@pytest.mark.parametrize("name,arr", _byte_chunks(),
                         ids=[c[0] for c in _byte_chunks()])
def test_tokenize_compact_matches_plain_exactly(cuda, name, arr):
    """The tokenize-and-compact kernel against its plain version: every row,
    the padding and the token count bit-equal."""
    from map_oxidize_tpu_torch.ops.device_tokenize import (
        tokenize_compact,
        tokenize_compact_plain,
    )

    chunk = torch.from_numpy(arr.copy()).to(cuda)
    max_tokens = arr.shape[0] // 2 + 1
    before = tokenize_compact.launches
    got = tokenize_compact(chunk, max_tokens)
    want = tokenize_compact_plain(chunk, max_tokens)
    torch.cuda.synchronize()
    assert tokenize_compact.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # fewer row slots than tokens: the rows past them drop, the count stays
    few, few_want = (tokenize_compact(chunk, 3),
                     tokenize_compact_plain(chunk, 3))
    for g, w in zip(few, few_want):
        assert torch.equal(g, w)


def _full_width_chunk(seed: int) -> np.ndarray:
    """A 32 MiB chunk (the device mapper's default) of short mixed-case
    words."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"abcdefgHIJK   \n", np.uint8),
                      size=32 << 20)


def test_tokenize_compact_repeats_its_bits(cuda):
    """20 launches on one 32 MiB chunk give the same bits, the first equal
    to the plain version: the tiles' look-back orders nothing by timing."""
    from map_oxidize_tpu_torch.ops.device_tokenize import (
        tokenize_compact,
        tokenize_compact_plain,
    )

    chunk = torch.from_numpy(_full_width_chunk(21)).to(cuda)
    max_tokens = chunk.shape[0] // 2 + 1
    first = tokenize_compact(chunk, max_tokens)
    want = tokenize_compact_plain(chunk, max_tokens)
    torch.cuda.synchronize()
    for g, w in zip(first, want):
        assert torch.equal(g, w)
    for _ in range(19):
        again = tokenize_compact(chunk, max_tokens)
        for g, w in zip(again, first):
            assert torch.equal(g, w)


def test_tokenize_compact_drops_rows_past_max_tokens_at_full_width(cuda):
    """At 32 MiB with fewer row slots than tokens (a count off the 16-byte
    stores): the kept rows, the count and no padding, as the plain
    version."""
    from map_oxidize_tpu_torch.ops.device_tokenize import (
        tokenize_compact,
        tokenize_compact_plain,
    )

    chunk = torch.from_numpy(_full_width_chunk(22)).to(cuda)
    n_tok = int(tokenize_compact_plain(chunk, 1)[3])
    for max_tokens in (n_tok // 3 + 1, n_tok - 1):
        got = tokenize_compact(chunk, max_tokens)
        want = tokenize_compact_plain(chunk, max_tokens)
        torch.cuda.synchronize()
        assert int(got[3]) == n_tok
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_tokenize_compact_built_layout_is_the_sources(cuda):
    """The layout the edge cases above are placed on is the built
    kernel's, and its shared memory holds a whole tile's rows (at most one
    per two bytes, 12 bytes each)."""
    from map_oxidize_tpu_torch.ops.device_tokenize import built_layout

    built = built_layout()
    assert {k: built[k] for k in _tokenize_layout()} == _tokenize_layout()
    assert built["dynamic_smem_bytes"] >= 12 * (built["tile"] // 2)


def test_tokenize_compact_refuses_what_it_cannot_take(cuda):
    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact

    chunk = torch.full((64,), 32, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tokenize_compact(chunk[1:], 10)
    with pytest.raises(ValueError, match="uint8"):
        tokenize_compact(chunk.int(), 10)


@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
def test_device_map_on_the_card_matches_the_cpu(cuda, tmp_path, workload):
    """``mapper='device'`` on the card (the kernel, the staging ring, the
    pinned packed fetch, the overflow fetch on its side stream) writes the
    CPU port's bytes, and launches the kernel once per chunk."""
    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact

    inp = _text_corpus(tmp_path / "c.txt", lines=40000)
    out = {}
    for backend in ("cuda", "cpu"):
        path = tmp_path / f"{backend}.txt"
        before = tokenize_compact.launches
        r = run_job(JobConfig(input_path=str(inp), output_path=str(path),
                              backend=backend, mapper="device",
                              chunk_bytes=96 << 10, device_chunk_keys=1 << 16,
                              metrics=False), workload)
        out[backend] = path.read_bytes()
        launched = tokenize_compact.launches - before
        assert launched == (r.metrics["chunks"] if backend == "cuda" else 0)
    assert out["cuda"] == out["cpu"]


def test_device_map_snapshot_resume_on_the_card(cuda, tmp_path, monkeypatch):
    """Killed past its first snapshot on the card, resumed: the bytes of an
    uninterrupted run."""
    import map_oxidize_tpu_torch.runtime.device_map as dm

    inp = _text_corpus(tmp_path / "c.txt", lines=30000)
    kw = dict(input_path=str(inp), backend="cuda", mapper="device",
              chunk_bytes=16 << 10, device_chunk_keys=1 << 13, metrics=False)
    run_job(JobConfig(output_path=str(tmp_path / "fresh.txt"), **kw))
    real = dm.iter_chunks_capped

    def dying(*a, **k):
        for i, c in enumerate(real(*a, **k)):
            if i == dm._SNAP_EVERY + 2:
                raise KeyboardInterrupt("simulated kill")
            yield c

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(dm, "iter_chunks_capped", dying)
    with pytest.raises(KeyboardInterrupt):
        run_job(JobConfig(output_path="", checkpoint_dir=ck, **kw))
    monkeypatch.setattr(dm, "iter_chunks_capped", real)
    run_job(JobConfig(output_path=str(tmp_path / "resumed.txt"),
                      checkpoint_dir=ck, **kw))
    assert (tmp_path / "resumed.txt").read_bytes() == (
        tmp_path / "fresh.txt").read_bytes()


@pytest.mark.parametrize("workload", ["sort", "join", "sessionize"])
def test_dataflow_card_sort_matches_the_host_sort(cuda, tmp_path, workload):
    """The dataflow jobs with their pairs sorted on the card write the host
    sort's bytes (and the CPU's)."""
    rng = np.random.default_rng(13)
    n = 200_000
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[keys == np.uint64(2**64 - 1)] = 0
    keys[:5000] = keys[0]
    pay = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    if workload != "sort":
        keys %= np.uint64(30_000)
    recs = tmp_path / "r.npy"
    np.save(recs, np.stack([keys, pay], axis=1))
    out = {}
    for name, backend, sort in (("card", "cuda", "device"),
                                ("host", "cuda", "host"),
                                ("cpu", "cpu", "device")):
        path = tmp_path / f"{name}.out"
        run_job(JobConfig(input_path=str(recs), output_path=str(path),
                          join_input_path=str(recs), backend=backend,
                          collect_sort=sort, chunk_bytes=1 << 20,
                          metrics=False), workload)
        out[name] = path.read_bytes()
    assert out["card"] == out["host"] == out["cpu"]


def test_ledger_samples_the_kernel_within_its_call_to_ready_wall(cuda):
    """The launch ledger's sampled device time of a k-means step on the
    card (a pair of events on the step's stream around the call, resolved
    once the end event has completed) is positive and no larger than the
    wall from the call to the result being ready."""
    import time

    from map_oxidize_tpu_torch.obs import compile as led
    from map_oxidize_tpu_torch.workloads.kmeans import _kmeans_step_impl

    step = led.ObservedProgram("test/kmeans_step", _kmeans_step_impl,
                               ledger=led.CompileLedger(), sample_every=1)
    rng = np.random.default_rng(49)
    p = torch.from_numpy(rng.normal(size=(1 << 20, 64)).astype(
        np.float32)).to(cuda)
    c = p[:256].clone()
    step(c, p, 256)  # the first call compiles (builds the kernel)
    torch.cuda.synchronize()
    step._ledger.resolve()  # the compile's own sample
    stats = step._ledger.programs["test/kmeans_step"]
    samples, sampled_ms = stats.samples, stats.sampled_ms
    t0 = time.perf_counter()
    out = step(c, p, 256)  # every dispatch is sampled at sample_every=1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    step._ledger.resolve()
    assert stats.samples == samples + 1
    assert 0 < stats.sampled_ms - sampled_ms <= wall_ms
    assert out.shape == c.shape and torch.isfinite(out).all()


def test_a_sampled_dispatch_returns_before_its_kernel_ends(cuda):
    """A sampled dispatch of a long kernel returns while the kernel runs:
    the ledger records an event pair and waits for nothing; the pair
    resolves to the kernel's time once it has ended.  The compile is
    sampled too: its pair less the call's wall, the kernel's time when
    the call returned at once (its kernels loaded before)."""
    import time

    from map_oxidize_tpu_torch.obs import compile as led

    def spin(x):
        torch.cuda._sleep(1 << 29)  # ~0.3 s of one thread's clock
        return x + 1

    prog = led.ObservedProgram("test/spin", spin, ledger=led.CompileLedger(),
                               sample_every=1)
    x = torch.zeros(4, device=cuda)
    spin(x)  # loads the kernels (a first launch may wait for the card)
    torch.cuda.synchronize()
    prog(x)  # the compile
    torch.cuda.synchronize()
    prog._ledger.resolve()
    stats = prog._ledger.programs["test/spin"]
    assert stats.samples == 1 and stats.sampled_ms > 100.0
    compile_ms = stats.sampled_ms
    t0 = time.perf_counter()
    prog(x)
    call_ms = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.Event()
    after.record()
    running = not after.query()
    assert running and stats.samples == 1
    torch.cuda.synchronize()
    prog._ledger.resolve()
    assert stats.samples == 2
    kernel_ms = stats.sampled_ms - compile_ms
    assert kernel_ms > 100.0 and call_ms < 0.1 * kernel_ms
    assert abs(compile_ms - kernel_ms) <= 0.2 * kernel_ms


def test_ledger_event_time_of_a_fit_is_the_outer_events_time(cuda):
    """In a job window, the ledger's event time of ``kmeans/fit`` is
    within 10% of CUDA events recorded around the same call."""
    from map_oxidize_tpu_torch.obs import Obs
    from map_oxidize_tpu_torch.workloads.kmeans import _kmeans_fit

    rng = np.random.default_rng(50)
    p = torch.from_numpy(rng.normal(size=(1 << 20, 64)).astype(
        np.float32)).to(cuda)
    c = p[:256].clone()
    _kmeans_fit(c, p, 256, 5)  # the compile, outside the window
    torch.cuda.synchronize()
    obs = Obs.from_config(JobConfig(backend="cuda"))
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    _kmeans_fit(c, p, 256, 5)
    b.record()
    torch.cuda.synchronize()
    row = obs.finish_xprof()["programs"]["kmeans/fit"]
    outer = a.elapsed_time(b)
    assert row["device_samples"] == 1
    assert abs(row["sampled_device_ms"] - outer) <= 0.1 * outer


def test_auto_b_stream_fit_on_the_card_is_bit_equal_to_b1(cuda, tmp_path):
    """``dispatch_batch=0`` resolves B through the dispatch resolver on the
    card (``platform='gpu'``, capped by the device memory) and the fit is
    bit-equal to B=1."""
    from map_oxidize_tpu_torch.obs.compile import assign_sum_ops
    from map_oxidize_tpu_torch.runtime import dispatch
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_streamed_device,
    )

    dispatch._auto_cache.clear()
    pts = _int_points(50, 40_003, 32, 16)
    path = str(tmp_path / "p.npy")
    np.save(path, pts)
    kw = dict(iters=3, chunk_rows=1000, device=cuda)
    timings = {}
    auto = kmeans_fit_streamed_device(path, pts[:16], dispatch_batch=0,
                                      timings=timings, **kw)
    one = kmeans_fit_streamed_device(path, pts[:16], dispatch_batch=1, **kw)
    assert auto.tobytes() == one.tobytes()
    assert dispatch._platform() == "gpu" and dispatch.hbm_budget_bytes() > 0
    b, info = dispatch.resolve_dispatch_batch(
        0, n_chunks=41, chunk_device_bytes=1000 * 32 * 4,
        flops_per_chunk=assign_sum_ops(1000, 16, 32))
    assert b == timings["dispatch_batch"] and info["hbm_cap"] >= 1


# --- the resident job service on the card -----------------------------------


@pytest.fixture(scope="module")
def card_server(tmp_path_factory):
    """One resident server of the port in this process, warmed on the
    card, with a small blob file to serve k-means jobs on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the server's jobs run on it")
    import time

    from map_oxidize_tpu_torch.config import ServeConfig
    from map_oxidize_tpu_torch.serve.client import ServeClient
    from map_oxidize_tpu_torch.serve.server import ResidentServer

    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tmp_path_factory.mktemp("card_serve")
    rng = np.random.default_rng(9)
    centres = rng.integers(-50, 50, (64, 32)).astype(np.float32) * 8
    pts = (centres[rng.integers(0, 64, 1 << 16)]
           + rng.integers(-2, 3, ((1 << 16), 32))).astype(np.float32)
    path = str(tmp / "pts.npy")
    np.save(path, pts)
    srv = ResidentServer(ServeConfig(
        port=0, workers=2, spool_dir=str(tmp / "spool"),
        obs_sample_s=0.1).validate()).start()
    c = ServeClient(srv.url, timeout_s=60)
    deadline = time.monotonic() + 120
    while "hbm/budget_bytes" not in c.status()["hbm"]:
        assert time.monotonic() < deadline, "the warm-up never finished"
        time.sleep(0.05)
    yield srv, c, path, tmp
    srv.shutdown()


def _served_kmeans(c, path, out, **kw):
    cfg = dict({"kmeans_k": 64, "kmeans_iters": 5}, **kw)
    row = c.wait(c.submit("kmeans", path, config=cfg, output=out)["id"],
                 timeout_s=300)
    assert row["state"] == "done", row.get("reason")
    return c.job(row["id"])


def test_serve_warmup_sets_the_budget_to_the_card_memory(card_server):
    _srv, c, _path, _tmp = card_server
    total = sum(torch.cuda.get_device_properties(i).total_memory
                for i in range(torch.cuda.device_count()))
    assert c.status()["hbm"]["hbm/budget_bytes"] == total
    assert c.jobs()["hbm"]["budget_bytes"] == total


def test_served_kmeans_is_bit_equal_to_run_job(card_server):
    _srv, c, path, tmp = card_server
    out = str(tmp / "served.npy")
    row = _served_kmeans(c, path, out)
    r = run_job(JobConfig(input_path=path, output_path="", kmeans_k=64,
                          kmeans_iters=5, metrics=False), "kmeans")
    assert np.array_equal(np.load(out), r.centroids)
    assert row["metrics"]["device"].startswith("cuda")


def test_a_second_served_job_of_the_same_shape_compiles_nothing(
        card_server):
    _srv, c, path, tmp = card_server
    _served_kmeans(c, path, str(tmp / "first.npy"), kmeans_iters=3)
    row = _served_kmeans(c, path, str(tmp / "second.npy"), kmeans_iters=3)
    assert row["compiles"] == 0
    assert row["metrics"]["compile/total_compiles"] == 0


def test_profile_capture_during_a_served_job_names_the_kernel(card_server):
    """A ``POST /profile`` capture on the HTTP handler's thread, taken while
    a worker thread's k-means fit runs, records the kernel (CUPTI traces
    the whole process); the fit outlasts the capture's window."""
    import json
    import time

    _srv, c, path, tmp = card_server
    row = c.submit("kmeans", path, output=str(tmp / "captured.npy"),
                   config={"kmeans_k": 64, "kmeans_iters": 100_000,
                           "kmeans_precision": "bf16"})
    while row["state"] in ("queued", "running") and row.get(
            "phase") != "iterate":
        time.sleep(0.02)
        row = c.job(row["id"])
    assert row["state"] == "running"
    doc = c._request("/profile", {"duration_s": 2.0})
    row = c.wait(row["id"], timeout_s=600)
    assert row["state"] == "done"
    assert c.job(row["id"])["finished_unix_s"] >= \
        doc["t_unix_s"] + doc["duration_s"]
    dev = doc["device"]
    assert "error" not in dev and "skipped" not in dev
    with open(dev["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("kmeans_assign_sum" in e.get("name", "") for e in events)


# --- the offline obs tooling over card documents ----------------------------


@pytest.fixture(scope="module")
def card_documents(tmp_path_factory):
    """Two k-means fits on the card into one ledger and calibration
    store, each with a metrics document."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the documents come from card jobs")
    tmp = tmp_path_factory.mktemp("card_obs")
    rng = np.random.default_rng(12)
    centres = rng.integers(-50, 50, (32, 16)).astype(np.float32) * 8
    pts = (centres[rng.integers(0, 32, 1 << 15)]
           + rng.integers(-2, 3, ((1 << 15), 16))).astype(np.float32)
    path = str(tmp / "pts.npy")
    np.save(path, pts)
    for i in range(2):
        run_job(JobConfig(input_path=path, output_path="", kmeans_k=32,
                          kmeans_iters=4, metrics=False,
                          ledger_dir=str(tmp / "ledger"),
                          calib_dir=str(tmp / "calib"),
                          metrics_out=str(tmp / f"m{i}.json")), "kmeans")
    return tmp


def _obs_subprocess(runs):
    """Run ``obs`` subcommands in one fresh process; returns each one's
    ``(rc, stdout)`` and whether torch (and so CUDA) was ever loaded."""
    import json
    import os
    import subprocess
    import sys

    script = (
        "import contextlib, io, json, sys\n"
        "from map_oxidize_tpu_torch.cli import main\n"
        "res = []\n"
        f"for argv in {runs!r}:\n"
        "    out = io.StringIO()\n"
        "    with contextlib.redirect_stdout(out), \\\n"
        "            contextlib.redirect_stderr(io.StringIO()):\n"
        "        rc = main(['obs', *argv])\n"
        "    res.append((rc, out.getvalue()))\n"
        "print(json.dumps({'res': res, 'torch': 'torch' in sys.modules}))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", script], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_obs_xprof_on_a_card_kmeans_document_names_the_fit(card_documents):
    """``obs xprof`` on a card k-means document names ``kmeans/fit`` with
    its achieved rate and MFU against the card's published peaks."""
    got = _obs_subprocess([["xprof", str(card_documents / "m1.json")]])
    ((rc, out),) = got["res"]
    assert rc == 0
    assert "kmeans/fit" in out and "published" in out


def test_no_offline_obs_subcommand_initialises_cuda(card_documents):
    d = card_documents
    runs = [["xprof", f"{d}/m0.json"], ["where", f"{d}/m0.json"],
            ["plan", f"{d}/m1.json"], ["critpath", f"{d}/m1.json"],
            ["calib", f"{d}/calib"], ["diff", "--ledger-dir", f"{d}/ledger"],
            ["trend", "--ledger-dir", f"{d}/ledger", "--json"]]
    got = _obs_subprocess(runs)
    assert [rc for rc, _ in got["res"]] == [0] * len(runs)
    assert got["torch"] is False


def test_a_collector_over_the_card_server_sees_its_kernel_launches(
        card_server):
    """The fleet collector discovers the card server through its spool,
    carries it as a labelled target with its device-memory gauges, and the
    target it found publishes the kernel's launches."""
    import urllib.request

    from map_oxidize_tpu_torch.config import FleetConfig
    from map_oxidize_tpu_torch.obs.fleet import FleetCollector

    srv, c, path, tmp = card_server
    _served_kmeans(c, path, str(tmp / "fleet.npy"), kmeans_iters=3)
    col = FleetCollector(FleetConfig(spool_dirs=[str(tmp / "spool")],
                                     discover_dir="none").validate())
    try:
        doc = col.poll_once()
        (row,) = doc["targets"]
        assert row["kind"] == "serve" and row["state"] == "up"
        assert row["hbm_bytes"] > 0 and row["hbm_frac"] > 0
        text = col.metrics_text()
        assert f'moxt_fleet_target_up{{target="{row["target"]}"}} 1' in text
        assert f'moxt_fleet_target_hbm_bytes{{target="{row["target"]}"}}' \
            in text
        target = urllib.request.urlopen(row["url"] + "/metrics",
                                        timeout=30).read().decode()
        launches = [float(line.rpartition(" ")[2])
                    for line in target.splitlines()
                    if line.startswith("moxt_kernels_kmeans_assign_sum_"
                                       "launches ")]
        assert launches and launches[0] > 0
    finally:
        col.stop()


# --- the sharded engines: 8 virtual slots on the card ---------------------


def _blob_points(path, n=40_000, d=16, k=8, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 30, size=(k, d))
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.normal(0, 0.5, (n, d))).astype(np.float32)
    pts[:k] = centres
    np.save(path, pts)
    return pts


def test_sharded_wordcount_on_the_card_equals_one_shard(cuda, tmp_path):
    """An 8-shard word count on one card (8 virtual slots on cuda:0) writes
    the one-shard run's bytes under both exchange wire programs, through
    the native and the device map (one tokenize launch per shard per
    group)."""
    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact

    rng = np.random.default_rng(1)
    words = [b"w%dq" % i for i in range(3000)]
    z = rng.zipf(1.2, size=(20_000, 10)) % len(words)
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"\n".join(b" ".join(words[j] for j in row)
                               for row in z) + b"\n")
    kw = dict(input_path=str(inp), chunk_bytes=1 << 16, batch_size=1 << 14)
    outs = {}
    for tag, extra in (("one", dict(num_shards=1)),
                       ("a2a", dict(num_shards=8)),
                       ("ag", dict(num_shards=8,
                                   exchange_collective="all_gather")),
                       ("dev", dict(num_shards=8, mapper="device",
                                    device_chunk_keys=1 << 14))):
        out = tmp_path / f"{tag}.txt"
        before = tokenize_compact.launches
        r = run_job(JobConfig(output_path=str(out), **kw, **extra),
                    "wordcount")
        outs[tag] = out.read_bytes()
        if extra.get("num_shards", 1) > 1:
            assert r.metrics["accumulator_device"] == "cuda:0"
            assert r.metrics["shuffle/exchanges"] >= 1
        if tag == "dev":
            groups = -(-r.metrics["chunks"] // 8)
            assert tokenize_compact.launches - before == 8 * groups
    assert outs["a2a"] == outs["one"]
    assert outs["ag"] == outs["one"]
    assert outs["dev"] == outs["one"]


@pytest.mark.parametrize("mode", ["device", "stream_device"])
def test_sharded_kmeans_on_the_card_matches_one_shard(cuda, tmp_path, mode):
    """An 8-shard k-means on one card: the kernel runs once per shard per
    iteration (or per chunk), the counts equal the one-shard fit's, the
    centroids agree within 1e-5 * max|x|, and a second 8-shard run is
    bit-equal (the psum adds the shard partials in shard order)."""
    from map_oxidize_tpu_torch.workloads.kmeans import assign_points

    path = tmp_path / "pts.npy"
    pts = _blob_points(path)
    kw = dict(input_path=str(path), output_path="", kmeans_k=8,
              kmeans_iters=5)
    kw.update(dict(mapper="device") if mode == "device" else
              dict(kmeans_device_fit_bytes=64, chunk_bytes=1 << 18))
    one = run_job(JobConfig(num_shards=1, **kw), "kmeans")
    before = fused_assign_sum.launches
    a = run_job(JobConfig(num_shards=8, **kw), "kmeans")
    launches = fused_assign_sum.launches - before
    b = run_job(JobConfig(num_shards=8, **kw), "kmeans")
    assert a.metrics["kmeans_shards"] == 8
    if mode == "device":
        assert launches == 8 * 5
    else:
        assert launches >= 8 * 5
    assert a.centroids.tobytes() == b.centroids.tobytes()
    np.testing.assert_array_equal(
        np.bincount(assign_points(pts, a.centroids), minlength=8),
        np.bincount(assign_points(pts, one.centroids), minlength=8))
    np.testing.assert_allclose(a.centroids, one.centroids, rtol=0,
                               atol=1e-5 * float(np.abs(pts).max()))


# --- the multi-process drivers: 2 processes x 4 slots on the card ---------

_DIST_CHILD = r"""
import json, sys
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.ops import kernel_launches
from map_oxidize_tpu_torch.parallel import distributed as D
pid, port, workload, cfg, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 json.loads(sys.argv[4]), sys.argv[5])
r = D.run_distributed_job(JobConfig(
    **cfg, dist_coordinator=f"127.0.0.1:{port}", dist_num_processes=2,
    dist_process_id=pid), workload)
D.shutdown_distributed()
c = r.centroids
json.dump({"launches": kernel_launches(), "top": [[w.decode(), n] for
           _h, w, n in r.top], "centroids": None if c is None
           else c.tobytes().hex()}, open(out % pid, "w"))
"""


def _two_processes(tmp_path, workload, cfg):
    """``workload`` in 2 card processes (4 slots each on cuda:0), the
    spawn retried once on a fresh port; their reports."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = str(tmp_path / f"{workload}_%d.json")
    for attempt in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _DIST_CHILD, str(i), str(port), workload,
             json.dumps(cfg), out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append("(timeout)")
                p.wait()
        if all(p.returncode == 0 for p in procs):
            return [json.load(open(out % i)) for i in range(2)]
        assert attempt == 0 and not any("(timeout)" in g for g in logs), \
            logs
    raise AssertionError("unreachable")


def test_two_process_wordcount_on_the_card_equals_one_process(cuda,
                                                              tmp_path):
    """2 processes x 4 slots on cuda:0 write the one-process S=8 run's
    bytes (parts concatenated and sorted) and report its top-k."""
    rng = np.random.default_rng(2)
    words = [b"w%dq" % i for i in range(3000)]
    z = rng.zipf(1.2, size=(20_000, 10)) % len(words)
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"\n".join(b" ".join(words[j] for j in row)
                               for row in z) + b"\n")
    cfg = dict(input_path=str(inp), chunk_bytes=1 << 16,
               batch_size=1 << 14, num_shards=8, top_k=10)
    one = run_job(JobConfig(**dict(cfg, output_path=str(
        tmp_path / "one.txt"))), "wordcount")
    reports = _two_processes(tmp_path, "wordcount", dict(
        cfg, output_path=str(tmp_path / "p.txt")))
    rows = []
    for i in range(2):
        rows.extend((tmp_path / f"p.txt.part{i}of2").read_bytes()
                    .splitlines(keepends=True))
    assert b"".join(sorted(rows)) == (tmp_path / "one.txt").read_bytes()
    want = [[w.decode(), c] for w, c in one.top]
    assert reports[0]["top"] == reports[1]["top"] == want


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_two_process_kmeans_on_the_card_equals_one_process(cuda, tmp_path,
                                                           precision):
    """2 processes x 4 slots: each launches the kernel once per local
    shard per iteration, and the centroids are the one-process S=8 fit's
    bit for bit (the psum adds the 8 partials in shard order)."""
    path = tmp_path / "pts.npy"
    _blob_points(path)
    cfg = dict(input_path=str(path), output_path="", kmeans_k=8,
               kmeans_iters=5, num_shards=8, kmeans_precision=precision)
    one = run_job(JobConfig(mapper="device", **cfg), "kmeans")
    reports = _two_processes(tmp_path, "kmeans", cfg)
    for r in reports:
        assert r["launches"]["kmeans_assign_sum"] == 4 * 5
        assert bytes.fromhex(r["centroids"]) == one.centroids.tobytes()
