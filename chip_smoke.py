#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to their
plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card and a CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. card      the card's name and power limit (``nvidia-smi``);
2. build     every kernel of the port from the checkout's sources, one
             ``nvcc`` each, all started together;
3. kernels   each kernel against its plain version on the card at the
             k-means path's shapes, with times (CUDA events), the plain
             version's and one PyTorch library call's time, and the bound;
4. kmeans    ``run_job("kmeans")`` on seeded blobs (n=2^22, d=64, k=256,
             10 iterations) in both precisions, launch counts reset just
             before and read just after; one iteration against the NumPy
             oracle ``kmeans_model``;
5. wordcount ``run_job("wordcount")`` on a seeded Zipf corpus (~256 MB, ~1M
             mixed-case words) against a ``collections.Counter`` oracle.

Then one JSON line with every kernel, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Inputs are made from fixed
seeds in a temporary directory, which is removed at the end.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261017
#: H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 on the
#: tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_ITERS = 1 << 22, 64, 256, 10
KERNEL_N = (1 << 22) + 777   # a ragged tail past the last full tile
KERNEL_KS = (256, 2048)
CORPUS_BYTES = 256 << 20
VOCAB = 1_000_000


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# --- phase 2 ----------------------------------------------------------------

def build_kernels() -> None:
    from map_oxidize_tpu_torch.ops import build

    t0 = time.perf_counter()
    paths = build.build(*build.KERNELS)
    log(f"built {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


# --- phase 3 ----------------------------------------------------------------

def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call over ``reps`` back-to-back calls (CUDA events),
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def assign_sum_bound(n: int, d: int, k: int, precision: str,
                     weighted: bool) -> tuple[float, str]:
    """Least time for one assign + sum on an H100: each input byte read
    once and the output written once, against 2nkd + nd operations at the
    peak rate of the operands' type."""
    p_bytes = n * d * (2 if precision == "bf16" else 4)
    nbytes = p_bytes + k * d * 4 + (n * 4 if weighted else 0) + k * (d + 1) * 4
    ops = 2 * n * k * d + n * d
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / (PEAK_BF16 if precision == "bf16" else PEAK_F32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_assign_sum(n: int, d: int, k: int, precision: str,
                     weighted: bool, g) -> dict:
    """The kernel against the plain version on two inputs.

    * integer-valued points and centroids (entries in -4..4): every score,
      sum and count is an exact integer in f32 and in bf16, and ties between
      centroids are common, so kernel and plain version must agree EXACTLY —
      the lowest index winning every tie included;
    * blobs (points near one of k centres): counts must agree exactly; the
      sums add the same values in another order, so each may differ by at
      most 1e-5 * m * M (m the centroid's count, M the largest |coordinate|;
      f32 unit roundoff is 6e-8).
    """
    import torch

    from map_oxidize_tpu_torch.ops.kmeans_kernel import (
        fused_assign_sum,
        fused_assign_sum_plain,
    )

    dev = torch.device("cuda")
    pdtype = torch.bfloat16 if precision == "bf16" else torch.float32
    w = ((torch.rand(n, generator=g, device=dev) > 0.3).float()
         if weighted else None)
    out = {"n": n, "d": d, "k": k, "precision": precision,
           "weighted": weighted}

    p = torch.randint(-4, 5, (n, d), generator=g, device=dev,
                      dtype=torch.int32).to(pdtype)
    c = torch.randint(-4, 5, (k, d), generator=g, device=dev,
                      dtype=torch.int32).float()
    s1, c1 = fused_assign_sum(p, c, k, precision, w=w)
    s2, c2 = fused_assign_sum_plain(p, c, k, precision, w=w)
    runs = [(s1, c1)]
    if precision == "bf16":  # the kernel also takes f32 points in bf16 mode
        runs.append(fused_assign_sum(p.float(), c, k, precision, w=w))
    torch.cuda.synchronize()
    for s1, c1 in runs:
        if not (torch.equal(c1, c2) and torch.equal(s1, s2)):
            raise AssertionError(
                f"integer inputs {out}: kernel != plain (counts differ in "
                f"{int((c1 != c2).sum())} centroids, max |dsum| "
                f"{float((s1 - s2).abs().max())})")
    del p, c, runs, s1, c1, s2, c2

    centres = torch.randn(k, d, generator=g, device=dev) * 10
    labels = torch.randint(0, k, (n,), generator=g, device=dev)
    p = (centres[labels]
         + 0.5 * torch.randn(n, d, generator=g, device=dev)).to(pdtype)
    c = centres + 0.1 * torch.randn(k, d, generator=g, device=dev)
    del labels, centres
    s1, c1 = fused_assign_sum(p, c, k, precision, w=w)
    s2, c2 = fused_assign_sum_plain(p, c, k, precision, w=w)
    torch.cuda.synchronize()
    if not torch.equal(c1, c2):
        raise AssertionError(f"blob inputs {out}: counts differ in "
                             f"{int((c1 != c2).sum())} centroids")
    pmax = float(p.float().abs().max())
    err = (s1 - s2).abs()
    allowed = 1e-5 * c2[:, None] * pmax + 1e-4
    if not bool((err <= allowed).all()):
        raise AssertionError(f"blob inputs {out}: max |dsum| "
                             f"{float(err.max())} past 1e-5*m*M")
    out["max_abs_err"] = float(err.max())

    out["ms"] = time_ms(lambda: fused_assign_sum(p, c, k, precision, w=w),
                        reps=20)
    out["plain_ms"] = time_ms(
        lambda: fused_assign_sum_plain(p, c, k, precision, w=w), reps=5,
        warmup=1)
    # library yardstick: the score product p @ c.T alone (no argmin, no
    # sums), f32 with TF32 off or bf16 — PyTorch has no one call for
    # assign + sum
    cm = c.to(pdtype)
    out["library_ms"] = time_ms(lambda: p @ cm.T, reps=5, warmup=1)
    out["library_call"] = f"torch.matmul ({pdtype}) of p and c.T, product only"
    out["bound_ms"], out["bound_by"] = assign_sum_bound(n, d, k, precision,
                                                        weighted)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    return out


def phase_kernels() -> list[dict]:
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    configs = []
    for k in KERNEL_KS:
        for precision in ("highest", "bf16"):
            for weighted in (False, True):
                r = check_assign_sum(KERNEL_N, KMEANS_D, k, precision,
                                     weighted, g)
                configs.append(r)
                log(f"kmeans_assign_sum k={k} {precision:7s} "
                    f"w={int(weighted)}: kernel {r['ms']:.3f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, p@c.T {r['library_ms']:.3f} "
                    f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
                    f"{r['roofline_share']:.1%} of it reached), "
                    f"max|dsum| {r['max_abs_err']:.3g}")
                torch.cuda.empty_cache()
    return configs


# --- phase 4 ----------------------------------------------------------------

def make_blobs(n: int, d: int, k: int, seed: int) -> np.ndarray:
    """Points around k centres; the first k points are the centres, so the
    first-k init starts one centroid in every blob."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    pts = rng.normal(0, 0.5, size=(n, d)).astype(np.float32)
    pts += centres[rng.integers(0, k, size=n)]
    pts[:k] = centres
    return pts


def round_bf16(x: np.ndarray) -> np.ndarray:
    import torch

    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def phase_kmeans(tmp: str, backend: str, n: int, d: int, k: int,
                 iters: int, wrappers) -> dict:
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads.kmeans import kmeans_model

    t0 = time.perf_counter()
    pts = make_blobs(n, d, k, SEED + 1)
    path = os.path.join(tmp, "points.npy")
    np.save(path, pts)
    log(f"kmeans input: {n} x {d} points, k={k} "
        f"({time.perf_counter() - t0:.1f} s to make)")

    def cfg(precision, n_iters, out):
        return JobConfig(input_path=path, output_path=out, backend=backend,
                         kmeans_k=k, kmeans_iters=n_iters,
                         kmeans_precision=precision, metrics=False)

    for w in wrappers:
        w.launches = 0
    runs = {}
    for precision in ("highest", "bf16"):
        out = os.path.join(tmp, f"centroids_{precision}.npy")
        r = run_job(cfg(precision, iters, out), "kmeans")
        runs[precision] = r
        log(f"kmeans {precision}: {iters} iterations in "
            f"{r.metrics['time/iter_s']:.4f} s "
            f"({r.metrics['time/iter_s'] / iters * 1e3:.3f} ms/iter), "
            f"transfer {r.metrics['time/transfer_s']:.3f} s, "
            f"device {r.metrics['device']}")
        got = np.load(out)
        if got.shape != (k, d) or not np.isfinite(got).all():
            raise AssertionError(f"kmeans {precision}: bad centroids "
                                 f"{got.shape}")
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"kmeans launches over both runs: {launches}")

    # one iteration against the NumPy oracle; the blobs are separated far
    # past any rounding, so the assignment is the same, and from the exact
    # centres one iteration already reaches the fixed point that 10 reach
    init = pts[:k].copy()
    for precision in ("highest", "bf16"):
        src = pts if precision == "highest" else round_bf16(pts)
        want = kmeans_model(src, init)
        one = run_job(cfg(precision, 1, ""), "kmeans").centroids
        for name, got in (("1 iteration", one),
                          (f"{iters} iterations", runs[precision].centroids)):
            if not np.allclose(got, want, rtol=1e-4, atol=1e-3):
                raise AssertionError(
                    f"kmeans {precision} {name} vs kmeans_model: max |d| "
                    f"{np.abs(got - want).max()}")
        log(f"kmeans {precision}: 1 and {iters} iterations match "
            f"kmeans_model (max |d| {np.abs(one - want).max():.3g})")
    os.remove(path)
    return {"launches": launches,
            "ms_per_iter": {p: r.metrics["time/iter_s"] / iters * 1e3
                            for p, r in runs.items()}}


# --- phase 5 ----------------------------------------------------------------

def make_corpus(nbytes: int, vocab: int, seed: int) -> bytes:
    """Zipf (s=1.1) draws over ``vocab`` random lowercase words of 2..12
    letters, 30% capitalised and 5% upper-cased, space-separated, a newline
    every ~12 words."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 13, size=vocab)
    letters = rng.integers(ord("a"), ord("z") + 1, size=(vocab, 12),
                           dtype=np.uint8)
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1) ** 1.1)
    cdf /= cdf[-1]
    n_tok = int(nbytes / (np.sum(lens / np.arange(1, vocab + 1) ** 1.1)
                          / np.sum(1.0 / np.arange(1, vocab + 1) ** 1.1) + 1))
    idx = np.minimum(np.searchsorted(cdf, rng.random(n_tok)), vocab - 1)
    tl = lens[idx]
    starts = np.zeros(n_tok, np.int64)
    np.cumsum(tl[:-1] + 1, out=starts[1:])
    buf = np.empty(int(starts[-1] + tl[-1] + 1), np.uint8)
    caps = rng.random(n_tok)
    for j in range(12):
        m = tl > j
        ch = letters[idx[m], j]
        upper = caps[m] < (0.35 if j == 0 else 0.05)
        buf[starts[m] + j] = np.where(upper, ch - 32, ch)
    sep = np.where(rng.random(n_tok) < 1 / 12, ord("\n"), ord(" "))
    buf[starts + tl] = sep
    return buf.tobytes()


def phase_wordcount(tmp: str, backend: str, nbytes: int, vocab: int,
                    wrappers) -> dict:
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job

    t0 = time.perf_counter()
    data = make_corpus(nbytes, vocab, SEED + 2)
    path = os.path.join(tmp, "corpus.txt")
    with open(path, "wb") as f:
        f.write(data)
    log(f"corpus: {len(data)} bytes ({time.perf_counter() - t0:.1f} s to "
        "make)")
    out = os.path.join(tmp, "final_result.txt")
    cfg = JobConfig(input_path=path, output_path=out, backend=backend,
                    top_k=10, metrics=False)
    for w in wrappers:
        w.launches = 0
    r = run_job(cfg, "wordcount")
    launches = {w.__name__: w.launches for w in wrappers}
    m = r.metrics
    log(f"wordcount: {m['records_in']} tokens, {m['distinct_keys']} distinct,"
        f" {m['chunks']} chunks, job {m['time/job_s']:.2f} s "
        f"({m['records_in'] / m['time/job_s']:.0f} words/s), "
        f"map+reduce {m['time/map+reduce_s']:.2f} s, "
        f"finalize {m['time/finalize_s']:.2f} s, write "
        f"{m['time/write_s']:.2f} s, accumulator on "
        f"{m['accumulator_device']} at {m['capacity_rows']} rows; "
        f"launches {launches}")
    if not m["accumulator_device"].startswith(backend):
        raise AssertionError(f"accumulator on {m['accumulator_device']}")
    if m["capacity_rows"] <= JobConfig.initial_key_capacity:
        raise AssertionError("accumulator never grew past "
                             f"{JobConfig.initial_key_capacity}")
    t0 = time.perf_counter()
    oracle = collections.Counter(data.lower().split())
    if r.counts != oracle:
        raise AssertionError("wordcount counts differ from the Counter "
                             "oracle")
    want_top = sorted(oracle.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    if r.top != want_top:
        raise AssertionError(f"top-10 {r.top} != oracle {want_top}")
    with open(out, "rb") as f:
        lines = f.read().splitlines()
    if len(lines) != len(oracle):
        raise AssertionError("final_result.txt rows != distinct words")
    log(f"wordcount matches the Counter oracle and its top-10 "
        f"({time.perf_counter() - t0:.1f} s to check): {r.top[:3]}")
    return {"launches": launches, "metrics": m}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum

    # plain versions compute f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_kernels()
    wrappers = [fused_assign_sum]
    configs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="moxt_smoke_") as tmp:
        km = phase_kmeans(tmp, "cuda", KMEANS_N, KMEANS_D, KMEANS_K,
                          KMEANS_ITERS, wrappers)
        wc = phase_wordcount(tmp, "cuda", CORPUS_BYTES, VOCAB, wrappers)
    launches = km["launches"]["fused_assign_sum"]
    if launches != 2 * KMEANS_ITERS:
        raise AssertionError(f"kmeans path launched the kernel {launches} "
                             f"times, expected {2 * KMEANS_ITERS}")
    main_cfg = next(c for c in configs if c["k"] == KMEANS_K
                    and c["precision"] == "highest" and not c["weighted"])
    kernels = [{
        "name": "kmeans_assign_sum",
        "route": "cuda",
        "source": "map_oxidize_tpu_torch/ops/csrc/kmeans_assign_sum.cu",
        "replaces": "map_oxidize_tpu/ops/kmeans_kernel.py:50",
        "launches": launches,
        "max_abs_err": main_cfg["max_abs_err"],
        "ms": main_cfg["ms"],
        "plain_ms": main_cfg["plain_ms"],
        "bound_ms": main_cfg["bound_ms"],
        "bound_by": main_cfg["bound_by"],
        "library_ms": main_cfg["library_ms"],
        "checked_against_plain": True,
        "configs": configs,
    }]
    log(f"kmeans ms/iter {km['ms_per_iter']}; wordcount launches "
        f"{wc['launches']}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
