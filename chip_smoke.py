#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to their
plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card and a CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. card      the card's name and power limit (``nvidia-smi``);
2. build     every kernel of the port from the checkout's sources, one
             ``nvcc`` each, all started together, and beside them the
             native C++ host map library with ``g++``; each kernel's
             registers and spills (``-Xptxas -v``) and its HMMA
             (tensor-core) instruction count (``cuobjdump -sass``);
3. kernels   each kernel against its plain version on the card at the
             k-means path's shapes, with times (CUDA events), the plain
             version's and one PyTorch library call's time, the bound, and
             the launch plan (blocks per SM, shared bytes, resident
             centroids, partial in shared memory);
4. kmeans    ``run_job("kmeans")`` on seeded blobs (n=2^22, d=64, k=256,
             10 iterations) in both precisions, launch counts reset just
             before and read just after; then the kernel's own time per
             call beside the fit's ms/iter, and a ``torch.profiler`` trace
             of two fit steps (device busy share, top device ops); one
             iteration against the NumPy oracle ``kmeans_model``;
5. wordcount ``run_job("wordcount")`` on a seeded Zipf corpus (~256 MB, ~1M
             mixed-case words), once with ``mapper='auto'`` (the native C++
             scan in the prefetch thread) and once with ``mapper='python'``,
             each against a ``collections.Counter`` oracle, the two
             ``final_result.txt`` byte-identical;
6. resume    the same word count killed after 3 chunks and resumed from its
             checkpoint (phase 5's bytes, the prefix replayed, not
             re-mapped); the phase 4 k-means fit in both precisions killed
             after 4 of 10 iterations by an ``on_iter`` that raises, and
             resumed from its snapshot (bit-equal to phase 4's centroids,
             6 kernel launches);
7. stream    the streamed k-means: seeded blobs, n=2^24, d=64, k=512 (a
             4 GiB ``.npy``), ``run_job`` with ``mapper='auto'`` and no fit
             budget set, which must route to ``stream_device``; 5
             iterations in each precision, launch counts reset just before
             and read just after (one launch per chunk per iteration),
             ms/iter, host-to-device bytes and GB/s, ``feed_wait_s`` and
             ``overlap_ratio``; three stager schedules in turns (depth
             2 with B=1 as counted, the serial depth 1, and B=8; 2
             iterations each, two rounds), bit-equal, with their ms/iter;
             the kernel against its plain version at the chunk shapes; a
             ``torch.profiler`` window over one iteration (device busy,
             kernel and copy shares, the kernel's device time per chunk
             launch); ``mapper='device'`` on the same file
             (ms/iter) and one iteration of it against one of the stream
             (counts equal, centroids within 1e-5 * max|x|); the
             host-assign stream (``mapper='native'``, n=2^20, d=64, k=64)
             against ``kmeans_model``, twice, bit-equal; a streamed fit at
             n=2^22 killed after 2 of 5 iterations and resumed with a fit
             budget under which ``auto`` would pick ``device``: it adopts
             ``stream_device`` from the snapshot and ends bit-equal to the
             uninterrupted streamed fit.

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
CHUNK_BYTES = 32 << 20  # JobConfig's default: 8 chunks of the corpus
VOCAB = 1_000_000
WC_KILL_AFTER = 3       # chunks mapped before the simulated kill
KMEANS_KILL_AFTER = 4   # iterations run before the simulated kill
STREAM_N, STREAM_K, STREAM_ITERS = 1 << 24, 512, 5
SCHEDULE_ITERS = 2      # iterations per run of the stager schedules
HOST_N, HOST_K = 1 << 20, 64               # the host-assign stream
RESUME_N, RESUME_ITERS, RESUME_KILL_AFTER = 1 << 22, 5, 2


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# --- phase 2 ----------------------------------------------------------------

def sass_counts(path, opcode: str) -> dict[str, int]:
    """Instructions of ``opcode`` in each kernel of the built library, from
    ``cuobjdump -sass`` of the toolkit that built it."""
    from pathlib import Path

    from map_oxidize_tpu_torch.ops import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and f" {opcode}" in line:
            counts[fn] += 1
    return counts


def variant(mangled: str) -> str:
    """Readable name of a kernel from its mangled name."""
    for tag, name in (("assign_sum_partialIfLb0", "assign_sum f32/highest"),
                      ("assign_sum_partialIfLb1", "assign_sum f32/bf16"),
                      ("assign_sum_partialI13__nv_bfloat16Lb1",
                       "assign_sum bf16/bf16"),
                      ("prep_centroidsIf", "prep_centroids f32"),
                      ("prep_centroidsI13__nv_bfloat16",
                       "prep_centroids bf16"),
                      ("sum_partials", "sum_partials")):
        if tag in mangled:
            return name
    return mangled


def build_native() -> float:
    """Builds the native host map library with ``g++``, always (a library
    already on disk is rebuilt, so the build is this host's); returns
    seconds."""
    from map_oxidize_tpu_torch.native import build

    t0 = time.perf_counter()
    build._compile(force=True)
    return time.perf_counter() - t0


def build_kernels() -> dict:
    """Builds every kernel, and the native library beside them; logs each
    kernel's registers, spills and static shared bytes (``-Xptxas -v``) and
    its HMMA (tensor-core) instruction count; returns both, by variant."""
    from concurrent.futures import ThreadPoolExecutor

    from map_oxidize_tpu_torch.ops import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)
        paths = build.build(*build.KERNELS)
        log(f"built {len(paths)} kernel(s) in "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"built the native map library (g++) in {native.result():.1f} "
            "s")
    resources = {}
    for name, text in build.build_logs.items():
        fn = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = variant(line.split("'")[1])
                resources[fn] = {}
            elif fn is not None and ("registers" in line or "spill" in line):
                resources[fn]["ptxas"] = (resources[fn].get("ptxas", "")
                                          + " " + line.strip()).strip()
    for name, path in paths.items():
        for fn, count in sass_counts(path, "HMMA").items():
            resources.setdefault(variant(fn), {})["hmma"] = count
    for fn, r in resources.items():
        log(f"  {fn}: {r.get('ptxas', 'no ptxas report (cached build)')}; "
            f"HMMA instructions {r.get('hmma', 'n/a')}")
    return resources


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
        plan,
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
    pl = plan(torch.cuda.current_device(), pdtype == torch.bfloat16,
              precision == "bf16", n, d, k)
    out["plan"] = {key: pl[key] for key in (
        "grid", "blocks_per_sm", "smem_bytes", "resident", "acc_in_smem")}
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
                    f"max|dsum| {r['max_abs_err']:.3g}; {r['plan']}")
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
    prof = profile_fit_steps(pts, k, iters)

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
    ms_per_iter = {p: r.metrics["time/iter_s"] / iters * 1e3
                   for p, r in runs.items()}
    for precision, ms in ms_per_iter.items():
        log(f"kmeans {precision}: fit {ms:.3f} ms/iter, its kernel alone "
            f"{prof['kernel_ms'][precision]:.3f} ms per call")
    return {"launches": launches, "ms_per_iter": ms_per_iter, "path": path,
            "centroids": {p: r.centroids for p, r in runs.items()}, **prof}


def profile_fit_steps(pts: np.ndarray, k: int, iters: int) -> dict:
    """For each precision, on the fit's points, after the counted fits:
    the kernel's own time per call and the fit step's (CUDA events), a
    second fit's ms/iter (the counted ones are the first fits of the
    process), and a ``torch.profiler`` trace of four fit steps
    (``_kmeans_step_impl``): device busy time over the device span and over
    the host window, and the top device operations.  Returns the kernel ms,
    step ms and second-fit ms/iter per precision."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum
    from map_oxidize_tpu_torch.workloads.kmeans import (
        _kmeans_step_impl,
        kmeans_fit_device,
    )

    out = {"kernel_ms": {}, "step_ms": {}, "refit_ms_per_iter": {}}
    for precision in ("highest", "bf16"):
        timings = {}
        kmeans_fit_device(pts, pts[:k], iters, device="cuda", timings=timings,
                          precision=precision)
        out["refit_ms_per_iter"][precision] = timings["iter_s"] / iters * 1e3
        p = torch.from_numpy(pts).cuda()
        if precision == "bf16":
            p = p.to(torch.bfloat16)
        c0 = p[:k].float().contiguous()
        out["kernel_ms"][precision] = time_ms(
            lambda: fused_assign_sum(p, c0, k, precision), reps=10)
        out["step_ms"][precision] = time_ms(
            lambda: _kmeans_step_impl(c0, p, k, precision), reps=10)
        c = c0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                c = _kmeans_step_impl(c, p, k, precision)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side entries only (kernels, copies, sets): a CPU op's
        # device time repeats its kernels'
        dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
        busy = sum(e.time_range.elapsed_us() for e in dev)
        span = (max(e.time_range.end for e in dev)
                - min(e.time_range.start for e in dev)) if dev else 0.0
        ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
        ops.sort(key=lambda kv: -kv[1])
        log(f"kmeans {precision}: kernel {out['kernel_ms'][precision]:.3f} "
            f"ms/call, fit step {out['step_ms'][precision]:.3f} ms, second "
            f"fit {out['refit_ms_per_iter'][precision]:.3f} ms/iter; "
            f"profile of 4 steps: {len(dev)} device ops busy {busy:.0f} us "
            f"of a {span:.0f} us device span ({busy / max(span, 1e-9):.1%}) "
            f"and a {wall_us:.0f} us host window "
            f"({busy / wall_us:.1%}); top: " + "; ".join(
                f"{name[:48]} {t:.0f} us" for name, t in ops[:5]))
        del p, c, c0
        torch.cuda.empty_cache()
    return out


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


def wordcount_line(name: str, m: dict, launches: dict,
                   mapped: int | None = None) -> str:
    """One run's counts, times and rate; ``mapped``, for a resumed run, is
    the tokens of the chunks it mapped (not replayed), which its rate
    counts."""
    mapped = m["records_in"] if mapped is None else mapped
    return (f"wordcount {name}: {m['records_in']} tokens, "
            f"{m['distinct_keys']} distinct, {m['chunks']} chunks "
            f"({m['checkpoint/chunks_replayed']} replayed), job "
            f"{m['time/job_s']:.2f} s ({mapped} tokens mapped in this run, "
            f"{mapped / m['time/job_s']:.0f} words/s), "
            f"map+reduce {m['time/map+reduce_s']:.2f} s, "
            f"finalize {m['time/finalize_s']:.2f} s, write "
            f"{m['time/write_s']:.2f} s, accumulator on "
            f"{m['accumulator_device']} at {m['capacity_rows']} rows; "
            f"launches {launches}")


def phase_wordcount(tmp: str, backend: str, nbytes: int, vocab: int,
                    wrappers) -> dict:
    """The corpus through ``mapper='auto'`` (which must resolve to the
    native C++ mapper) and ``mapper='python'``: each against the Counter
    oracle and its top-10, the two outputs byte-identical."""
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import resolve_mapper, run_job

    t0 = time.perf_counter()
    data = make_corpus(nbytes, vocab, SEED + 2)
    path = os.path.join(tmp, "corpus.txt")
    with open(path, "wb") as f:
        f.write(data)
    log(f"corpus: {len(data)} bytes ({time.perf_counter() - t0:.1f} s to "
        "make)")
    t0 = time.perf_counter()
    oracle = collections.Counter(data.lower().split())
    want_top = sorted(oracle.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    del data
    log(f"Counter oracle: {len(oracle)} distinct "
        f"({time.perf_counter() - t0:.1f} s)")
    runs = {}
    for mapper in ("auto", "python"):
        out = os.path.join(tmp, f"final_result_{mapper}.txt")
        cfg = JobConfig(input_path=path, output_path=out, backend=backend,
                        chunk_bytes=CHUNK_BYTES, top_k=10, mapper=mapper,
                        metrics=False)
        resolved = resolve_mapper(cfg, "wordcount")
        if resolved != ("native" if mapper == "auto" else "python"):
            raise AssertionError(f"mapper={mapper!r} resolved to "
                                 f"{resolved!r}")
        for w in wrappers:
            w.launches = 0
        r = run_job(cfg, "wordcount")
        launches = {w.__name__: w.launches for w in wrappers}
        m = r.metrics
        log(wordcount_line(f"mapper={mapper} ({resolved})", m, launches))
        if not m["accumulator_device"].startswith(backend):
            raise AssertionError(f"accumulator on {m['accumulator_device']}")
        if m["capacity_rows"] <= JobConfig.initial_key_capacity:
            raise AssertionError("accumulator never grew past "
                                 f"{JobConfig.initial_key_capacity}")
        t0 = time.perf_counter()
        if r.counts != oracle:
            raise AssertionError(f"wordcount {resolved}: counts differ from "
                                 "the Counter oracle")
        if r.top != want_top:
            raise AssertionError(f"top-10 {r.top} != oracle {want_top}")
        with open(out, "rb") as f:
            n_lines = sum(1 for _ in f)
        if n_lines != len(oracle):
            raise AssertionError("final_result.txt rows != distinct words")
        log(f"wordcount {resolved} matches the Counter oracle and its "
            f"top-10 ({time.perf_counter() - t0:.1f} s to check): "
            f"{r.top[:3]}")
        runs[resolved] = {"launches": launches, "metrics": m, "out": out}
        del r
    with open(runs["native"]["out"], "rb") as f:
        native_bytes = f.read()
    with open(runs["python"]["out"], "rb") as f:
        if f.read() != native_bytes:
            raise AssertionError("native and python final_result.txt "
                                 "differ")
    log(f"native and python final_result.txt byte-identical "
        f"({len(native_bytes)} bytes)")
    return {"path": path, "runs": runs}


# --- phase 6 ----------------------------------------------------------------

def phase_resume_wordcount(tmp: str, backend: str, wc: dict,
                           wrappers) -> dict:
    """Phase 5's native word count with a checkpoint directory, killed
    (``KeyboardInterrupt`` from the native chunk iterator, which runs in the
    prefetch thread) after ``WC_KILL_AFTER`` chunks, then resumed through
    ``run_job``: phase 5's bytes, the killed prefix replayed and not
    re-mapped, the checkpoint directory removed."""
    from map_oxidize_tpu_torch.api import SumReducer
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
    from map_oxidize_tpu_torch.workloads.wordcount import WordCountMapper

    class DyingMapper(WordCountMapper):
        mapped = 0
        records = 0

        def map_file(self, *a, **k):
            def gen(it):
                for item in it:
                    if self.mapped == WC_KILL_AFTER:
                        raise KeyboardInterrupt("simulated kill")
                    self.mapped += 1
                    self.records += item[0].records_in
                    yield item
            return gen(super().map_file(*a, **k))

    ck = os.path.join(tmp, "wc_checkpoint")
    out = os.path.join(tmp, "final_result_resumed.txt")
    cfg = JobConfig(input_path=wc["path"], output_path=out, backend=backend,
                    chunk_bytes=CHUNK_BYTES, top_k=10, checkpoint_dir=ck,
                    metrics=False)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    dying = DyingMapper()
    try:
        run_wordcount_job(cfg, dying, SumReducer())
        raise AssertionError("the killed word count ran to its end")
    except KeyboardInterrupt:
        pass
    t_killed = time.perf_counter() - t0
    saved = sorted(n for n in os.listdir(ck) if n.startswith("chunk_"))
    if saved != [f"chunk_{i:06d}.npz" for i in range(WC_KILL_AFTER)]:
        raise AssertionError(f"killed run spilled {saved}")
    log(f"wordcount killed after {WC_KILL_AFTER} chunks "
        f"({t_killed:.2f} s), spill: {saved}")
    r = run_job(cfg, "wordcount")
    launches = {w.__name__: w.launches for w in wrappers}
    m = r.metrics
    mapped = m["records_in"] - dying.records
    log(wordcount_line("resumed", m, launches, mapped))
    want = wc["runs"]["native"]
    if m["checkpoint/chunks_replayed"] != WC_KILL_AFTER:
        raise AssertionError(f"replayed {m['checkpoint/chunks_replayed']}")
    if m["chunks"] != want["metrics"]["chunks"]:
        raise AssertionError(f"resumed run took {m['chunks']} chunks, a "
                             f"fresh one {want['metrics']['chunks']}: the "
                             "prefix was re-mapped")
    if m["records_in"] != want["metrics"]["records_in"]:
        raise AssertionError("resumed run counted other records")
    with open(out, "rb") as f, open(want["out"], "rb") as g:
        if f.read() != g.read():
            raise AssertionError("resumed final_result.txt differs from "
                                 "phase 5's")
    if os.path.exists(ck):
        raise AssertionError("checkpoint directory left after success")
    log("wordcount resume: byte-identical to phase 5, prefix replayed, "
        "checkpoint removed")
    return {"launches": launches, "metrics": m, "mapped": mapped}


def phase_resume_kmeans(tmp: str, backend: str, km: dict, wrappers) -> dict:
    """Phase 4's fit with a checkpoint directory, killed by an ``on_iter``
    that raises after ``KMEANS_KILL_AFTER`` of ``KMEANS_ITERS`` iterations,
    then resumed through ``run_job``: centroids bit-equal to phase 4's
    uninterrupted fit, one kernel launch per remaining iteration."""
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads import kmeans as tkm

    real_fit = tkm.kmeans_fit_device

    def dying_fit(*a, on_iter=None, **kw):
        def hook(i, c):
            on_iter(i, c)
            if i == KMEANS_KILL_AFTER:
                raise KeyboardInterrupt("simulated kill")
        return real_fit(*a, on_iter=hook, **kw)

    out = {"ms_per_iter": {}, "launches": {}}
    for precision in ("highest", "bf16"):
        ck = os.path.join(tmp, f"km_checkpoint_{precision}")
        cfg = JobConfig(input_path=km["path"], output_path="",
                        backend=backend, kmeans_k=KMEANS_K,
                        kmeans_iters=KMEANS_ITERS, checkpoint_dir=ck,
                        kmeans_precision=precision, metrics=False)
        for w in wrappers:
            w.launches = 0
        tkm.kmeans_fit_device = dying_fit
        t0 = time.perf_counter()
        try:
            run_job(cfg, "kmeans")
            raise AssertionError("the killed fit ran to its end")
        except KeyboardInterrupt:
            pass
        finally:
            tkm.kmeans_fit_device = real_fit
        t_killed = time.perf_counter() - t0
        killed = {w.__name__: w.launches for w in wrappers}
        for w in wrappers:
            w.launches = 0
        r = run_job(cfg, "kmeans")
        launches = {w.__name__: w.launches for w in wrappers}
        ran = KMEANS_ITERS - KMEANS_KILL_AFTER
        ms = r.metrics["time/iter_s"] / ran * 1e3
        log(f"kmeans {precision} resume: killed after {KMEANS_KILL_AFTER} "
            f"iterations ({t_killed:.2f} s, launches {killed}); resumed "
            f"{r.metrics.get('resumed_iters')} -> {r.metrics['iters']}: "
            f"{ran} iterations in {r.metrics['time/iter_s']:.4f} s "
            f"({ms:.3f} ms/iter with a snapshot per iteration; phase 4 "
            f"{km['ms_per_iter'][precision]:.3f} ms/iter without), launches "
            f"{launches}")
        if killed["fused_assign_sum"] != KMEANS_KILL_AFTER:
            raise AssertionError(f"killed fit launched {killed}")
        if launches["fused_assign_sum"] != ran:
            raise AssertionError(f"resumed fit launched {launches}, "
                                 f"expected {ran}")
        if r.metrics.get("resumed_iters") != KMEANS_KILL_AFTER:
            raise AssertionError(f"resumed at {r.metrics}")
        want = km["centroids"][precision]
        if r.centroids.tobytes() != want.tobytes():
            raise AssertionError(
                f"kmeans {precision}: resumed centroids differ from the "
                f"uninterrupted fit (max |d| "
                f"{np.abs(r.centroids - want).max()})")
        if os.path.exists(ck):
            raise AssertionError("snapshot left after success")
        log(f"kmeans {precision} resume: bit-equal to phase 4's "
            f"uninterrupted {KMEANS_ITERS}-iteration fit")
        out["ms_per_iter"][precision] = ms
        out["launches"][precision] = launches
    return out


# --- phase 7 ----------------------------------------------------------------

def save_blobs(path: str, n: int, d: int, k: int, seed: int) -> np.ndarray:
    """:func:`make_blobs`'s distribution, written to a ``.npy`` in slices of
    2^20 rows (no n x d float64 temporary); returns the centres."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(n, d))
    for s in range(0, n, 1 << 20):
        m = min(1 << 20, n - s)
        block = rng.standard_normal((m, d), dtype=np.float32)
        block *= 0.5
        block += centres[rng.integers(0, k, size=m)]
        out[s:s + m] = block
    out[:k] = centres
    out.flush()
    del out
    return centres


def device_intervals(prof) -> tuple[list, float, float]:
    """The device events of a ``torch.profiler`` trace as (start, end, name)
    in us, and the union of all their intervals and of the copies'."""
    ev = [(e.time_range.start, e.time_range.end, e.name)
          for e in prof.events() if str(e.device_type).endswith("CUDA")]

    def union(iv):
        total, end = 0.0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    return (ev, union([(a, b) for a, b, _ in ev]),
            union([(a, b) for a, b, name in ev if "Memcpy HtoD" in name]))


def profile_stream_iteration(path: str, init: np.ndarray, chunk_rows: int,
                             precision: str) -> dict:
    """One streamed iteration under ``torch.profiler``: the host window, the
    device's busy time (union of every device interval), the kernel's and
    the host-to-device copies' busy time, and the largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_streamed_device,
    )

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kmeans_fit_streamed_device(path, init, iters=1,
                                   chunk_rows=chunk_rows, device="cuda",
                                   precision=precision)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev, busy, copy = device_intervals(prof)
    kernel = sum(b - a for a, b, name in ev if "assign_sum" in name)
    # the wrapper's three kernels: centroid prep, assign + sum, partials
    wrapper = sum(b - a for a, b, name in ev if any(
        t in name for t in ("assign_sum", "prep_centroids", "sum_partials")))
    ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    ops.sort(key=lambda kv: -kv[1])
    return {"wall_ms": wall_us / 1e3, "busy_share": busy / wall_us,
            "kernel_share": kernel / wall_us, "copy_share": copy / wall_us,
            "wrapper_device_ms": wrapper / 1e3, "copy_ms": copy / 1e3,
            "device_ops": len(ev),
            "top": [(name[:48], round(t / 1e3, 3)) for name, t in ops[:5]]}


def phase_stream(tmp: str, backend: str, wrappers, g) -> dict:
    """The streamed k-means at n=2^24, d=64, k=512 (see the module
    docstring, phase 7)."""
    import torch

    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads import kmeans as tkm

    n, d, k = STREAM_N, KMEANS_D, STREAM_K
    t0 = time.perf_counter()
    path = os.path.join(tmp, "stream_points.npy")
    save_blobs(path, n, d, k, SEED + 3)
    log(f"stream input: {n} x {d} points, k={k}, "
        f"{os.path.getsize(path)} bytes ({time.perf_counter() - t0:.1f} s "
        "to make)")
    chunk_rows = CHUNK_BYTES // (4 * (d + 2 * k))
    n_chunks = -(-n // chunk_rows)
    tail = n - (n_chunks - 1) * chunk_rows
    fit_bytes = torch.cuda.mem_get_info()[1] // 2
    log(f"fit budget (half the card) {fit_bytes} bytes, working set "
        f"4n(d+2k) = {4 * n * (d + 2 * k)} bytes; chunks of {chunk_rows} "
        f"rows, {n_chunks} per iteration (tail {tail})")

    def cfg(precision, iters, **kw):
        return JobConfig(input_path=path, output_path="", backend=backend,
                         kmeans_k=k, kmeans_iters=iters,
                         kmeans_precision=precision, metrics=False, **kw)

    out = {"chunk_rows": chunk_rows, "n_chunks": n_chunks,
           "runs": {}, "configs": []}
    for w in wrappers:
        w.launches = 0
    for precision in ("highest", "bf16"):
        r = run_job(cfg(precision, STREAM_ITERS), "kmeans")
        m = r.metrics
        if m["kmeans_mode"] != "stream_device":
            raise AssertionError(f"auto routed n={n} to {m['kmeans_mode']}")
        if not np.isfinite(r.centroids).all() or r.centroids.shape != (k, d):
            raise AssertionError(f"stream {precision}: bad centroids")
        ms = m["time/feed_s"] / STREAM_ITERS * 1e3
        nbytes = n * d * (2 if precision == "bf16" else 4)
        out["runs"][precision] = {
            "ms_per_iter": ms, "h2d_bytes_per_iter": nbytes,
            "gb_per_s": nbytes / ms / 1e6,
            "feed_wait_s": m.get("pipeline/feed_wait_ms", 0.0) / 1e3,
            "overlap_ratio": m.get("pipeline/overlap_ratio"),
            "centroids": r.centroids}
        log(f"stream_device {precision}: {STREAM_ITERS} iterations in "
            f"{m['time/feed_s']:.3f} s ({ms:.3f} ms/iter), {nbytes} bytes "
            f"host->device per iteration ({nbytes / ms / 1e6:.3f} GB/s), "
            f"feed_wait {m.get('pipeline/feed_wait_ms', 0.0) / 1e3:.3f} s, "
            f"overlap_ratio {m.get('pipeline/overlap_ratio')}, B "
            f"{m['dispatch/batch']}")
    launches = {w.__name__: w.launches for w in wrappers}
    out["launches"] = launches
    want = 2 * STREAM_ITERS * n_chunks
    log(f"stream launches over both runs: {launches} (2 x {STREAM_ITERS} "
        f"iterations x {n_chunks} chunks = {want})")
    if launches["fused_assign_sum"] != want:
        raise AssertionError(f"stream launched {launches}, expected {want}")

    # beside the counted runs, three stager schedules in turns (two
    # rounds, the second in reverse order): the counted one (depth 2, B 1),
    # the serial one (depth 1: no stager thread) and blocks of 8 chunks
    # (the port has no auto-B resolver yet); all give the same bits
    schedules = (("depth 2, B 1", {}), ("depth 1, B 1",
                                        dict(pipeline_depth=1)),
                 ("depth 2, B 8", dict(dispatch_batch=8)))
    for precision in ("highest", "bf16"):
        times, ref = {}, None
        for rnd in range(2):
            for name, kw in (schedules if rnd == 0 else schedules[::-1]):
                r = run_job(cfg(precision, SCHEDULE_ITERS, **kw), "kmeans")
                times.setdefault(name, []).append(
                    r.metrics["time/feed_s"] / SCHEDULE_ITERS * 1e3)
                ref = r.centroids if ref is None else ref
                if r.centroids.tobytes() != ref.tobytes():
                    raise AssertionError(f"stream_device {precision} {name} "
                                         "differs from depth 2, B 1")
        out["runs"][precision]["schedules"] = times
        log(f"stream_device {precision}, {SCHEDULE_ITERS} iterations per "
            "run, in turns, ms/iter: " + "; ".join(
                f"{name} {', '.join(f'{t:.3f}' for t in ts)}"
                for name, ts in times.items()) + "; all bit-equal")

    # the kernel at the chunk shapes, against its plain version
    for rows in (chunk_rows, tail):
        for precision in ("highest", "bf16"):
            r = check_assign_sum(rows, d, k, precision, False, g)
            out["configs"].append(r)
            log(f"kmeans_assign_sum n={rows} k={k} {precision:7s}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, p@c.T "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['roofline_share']:.1%} of it "
                f"reached), max|dsum| {r['max_abs_err']:.3g}; {r['plan']}")
    init = np.load(path, mmap_mode="r")[:k].copy()
    for precision in ("highest", "bf16"):
        prof = profile_stream_iteration(path, init, chunk_rows, precision)
        run = out["runs"][precision]
        run["profile"] = prof
        nbytes = run["h2d_bytes_per_iter"]
        log(f"stream_device {precision} profile of one iteration: "
            f"{prof['wall_ms']:.3f} ms host window, device busy "
            f"{prof['busy_share']:.1%} of it (kernel "
            f"{prof['kernel_share']:.1%}, host->device copies "
            f"{prof['copy_share']:.1%}: {prof['copy_ms']:.3f} ms, "
            f"{nbytes / prof['copy_ms'] / 1e6:.3f} GB/s while copying), "
            f"{prof['device_ops']} device ops; top (ms): {prof['top']}")
        # device time of the wrapper's kernels per launch; the CUDA-event
        # time above is of back-to-back calls, which at this size includes
        # the host's launch gaps
        kern = prof["wrapper_device_ms"] / n_chunks
        run["kernel_device_ms_per_chunk"] = kern
        log(f"stream_device {precision}: the kernel's device time "
            f"{kern:.4f} ms per chunk launch (prep + assign_sum + "
            f"sum_partials) x {n_chunks} = {prof['wrapper_device_ms']:.3f} "
            f"ms of {run['ms_per_iter']:.3f} ms/iter")

    # beside it: the device-resident fit of the same file
    pts = np.load(path)
    for precision in ("highest", "bf16"):
        r = run_job(cfg(precision, STREAM_ITERS, mapper="device"), "kmeans")
        ms = r.metrics["time/iter_s"] / STREAM_ITERS * 1e3
        out["runs"][precision]["device_ms_per_iter"] = ms
        log(f"device {precision} on the same file: {ms:.3f} ms/iter "
            f"(transfer {r.metrics['time/transfer_s']:.3f} s once)")
        parts = []
        c_s = tkm.kmeans_fit_streamed_device(path, init, iters=1,
                                             chunk_rows=chunk_rows,
                                             device="cuda",
                                             precision=precision,
                                             partials=parts)
        p = torch.from_numpy(pts).cuda()
        if precision == "bf16":
            p = p.to(torch.bfloat16)
        c0 = torch.from_numpy(init).cuda()
        _, counts = fused_assign_sum(p, c0, k, precision)
        c_d = tkm._kmeans_step_impl(c0, p, k, precision).cpu().numpy()
        counts = counts.cpu().numpy()
        del p
        torch.cuda.empty_cache()
        if not np.array_equal(parts[0][:, -1], counts):
            raise AssertionError(
                f"{precision}: stream and device counts differ in "
                f"{int((parts[0][:, -1] != counts).sum())} centroids")
        bound = 1e-5 * float(np.abs(pts).max())
        err = float(np.abs(c_s - c_d).max())
        if err > bound:
            raise AssertionError(f"{precision}: stream vs device centroids "
                                 f"max |d| {err} past {bound}")
        log(f"{precision}: one streamed iteration against one device-"
            f"resident iteration: counts equal, centroids max |d| "
            f"{err:.3g} (bound 1e-5 * max|x| = {bound:.3g})")
    del pts

    # the host-assign stream
    hpath = os.path.join(tmp, "host_points.npy")
    save_blobs(hpath, HOST_N, d, HOST_K, SEED + 4)
    hpts = np.load(hpath)
    want_c = tkm.kmeans_model(hpts, hpts[:HOST_K])
    hcfg = JobConfig(input_path=hpath, output_path="", backend=backend,
                     kmeans_k=HOST_K, kmeans_iters=1, mapper="native",
                     metrics=False)
    host = [run_job(hcfg, "kmeans") for _ in range(2)]
    m = host[0].metrics
    if m["kmeans_mode"] != "stream":
        raise AssertionError(f"mapper=native ran {m['kmeans_mode']}")
    if host[0].centroids.tobytes() != host[1].centroids.tobytes():
        raise AssertionError("host-assign stream: two runs differ")
    if not np.allclose(host[0].centroids, want_c, rtol=1e-4, atol=1e-3):
        raise AssertionError(
            f"host-assign stream vs kmeans_model: max |d| "
            f"{np.abs(host[0].centroids - want_c).max()}")
    out["host"] = {"ms_per_iter": m["time/iter_s"] * 1e3,
                   "overlap_ratio": m.get("pipeline/overlap_ratio"),
                   "second_ms_per_iter": host[1].metrics["time/iter_s"] * 1e3}
    log(f"stream (host assign, n={HOST_N}, k={HOST_K}): "
        f"{m['time/iter_s'] * 1e3:.3f} ms/iter "
        f"(second run {out['host']['second_ms_per_iter']:.3f}), "
        f"overlap_ratio {m.get('pipeline/overlap_ratio')}; matches "
        f"kmeans_model (max |d| "
        f"{np.abs(host[0].centroids - want_c).max():.3g}), two runs "
        "bit-equal")
    del hpts
    out["resume"] = phase_stream_resume(tmp, backend, path, wrappers)
    return out


def phase_stream_resume(tmp: str, backend: str, big: str, wrappers) -> dict:
    """A streamed fit of the first 2^22 points killed after
    ``RESUME_KILL_AFTER`` of ``RESUME_ITERS`` iterations, resumed with a fit
    budget under which ``auto`` would pick ``device``: it adopts
    ``stream_device`` from the snapshot and ends bit-equal to the
    uninterrupted streamed fit."""
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads import kmeans as tkm

    path = os.path.join(tmp, "resume_points.npy")
    np.save(path, np.load(big, mmap_mode="r")[:RESUME_N])
    d, k = KMEANS_D, STREAM_K
    chunk_rows = CHUNK_BYTES // (4 * (d + 2 * k))
    n_chunks = -(-RESUME_N // chunk_rows)
    small = 4 * RESUME_N * (d + 2 * k) - 1  # auto streams under this budget
    real_fit = tkm.kmeans_fit_streamed_device

    def dying_fit(*a, on_iter=None, **kw):
        def hook(i, c):
            on_iter(i, c)
            if i == RESUME_KILL_AFTER:
                raise KeyboardInterrupt("simulated kill")
        return real_fit(*a, on_iter=hook, **kw)

    out = {}
    for precision in ("highest", "bf16"):
        ck = os.path.join(tmp, f"stream_checkpoint_{precision}")

        def cfg(fit_bytes, ckdir):
            return JobConfig(input_path=path, output_path="",
                             backend=backend, kmeans_k=k,
                             kmeans_iters=RESUME_ITERS,
                             kmeans_precision=precision,
                             kmeans_device_fit_bytes=fit_bytes,
                             checkpoint_dir=ckdir, metrics=False)

        want = run_job(cfg(small, None), "kmeans")
        if want.metrics["kmeans_mode"] != "stream_device":
            raise AssertionError(f"budget {small} ran "
                                 f"{want.metrics['kmeans_mode']}")
        for w in wrappers:
            w.launches = 0
        tkm.kmeans_fit_streamed_device = dying_fit
        try:
            run_job(cfg(small, ck), "kmeans")
            raise AssertionError("the killed streamed fit ran to its end")
        except KeyboardInterrupt:
            pass
        finally:
            tkm.kmeans_fit_streamed_device = real_fit
        killed = {w.__name__: w.launches for w in wrappers}
        for w in wrappers:
            w.launches = 0
        r = run_job(cfg(1 << 50, ck), "kmeans")
        launches = {w.__name__: w.launches for w in wrappers}
        ran = RESUME_ITERS - RESUME_KILL_AFTER
        log(f"stream_device {precision} resume (n={RESUME_N}): killed after "
            f"{RESUME_KILL_AFTER} iterations (launches {killed}); resumed "
            f"in mode {r.metrics['kmeans_mode']} at "
            f"{r.metrics.get('resumed_iters')} -> {r.metrics['iters']}, "
            f"{r.metrics['time/feed_s'] / ran * 1e3:.3f} ms/iter with a "
            f"snapshot per iteration (uninterrupted "
            f"{want.metrics['time/feed_s'] / RESUME_ITERS * 1e3:.3f}), "
            f"launches {launches}")
        if killed["fused_assign_sum"] != RESUME_KILL_AFTER * n_chunks:
            raise AssertionError(f"killed fit launched {killed}")
        if launches["fused_assign_sum"] != ran * n_chunks:
            raise AssertionError(f"resumed fit launched {launches}")
        if (r.metrics["kmeans_mode"] != "stream_device"
                or r.metrics.get("resumed_iters") != RESUME_KILL_AFTER):
            raise AssertionError(f"resume did not adopt the snapshot: "
                                 f"{r.metrics}")
        if r.centroids.tobytes() != want.centroids.tobytes():
            raise AssertionError(
                f"stream_device {precision}: resumed centroids differ from "
                f"the uninterrupted fit (max |d| "
                f"{np.abs(r.centroids - want.centroids).max()})")
        if os.path.exists(ck):
            raise AssertionError("snapshot left after success")
        log(f"stream_device {precision} resume: adopted stream_device, "
            "bit-equal to the uninterrupted streamed fit")
        out[precision] = {
            "ms_per_iter": r.metrics["time/feed_s"] / ran * 1e3,
            "uninterrupted_ms_per_iter":
                want.metrics["time/feed_s"] / RESUME_ITERS * 1e3}
    return out


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
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; host "
        f"{os.cpu_count()} CPUs")
    resources = build_kernels()
    wrappers = [fused_assign_sum]
    configs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="moxt_smoke_") as tmp:
        km = phase_kmeans(tmp, "cuda", KMEANS_N, KMEANS_D, KMEANS_K,
                          KMEANS_ITERS, wrappers)
        wc = phase_wordcount(tmp, "cuda", CORPUS_BYTES, VOCAB, wrappers)
        wc_resume = phase_resume_wordcount(tmp, "cuda", wc, wrappers)
        km_resume = phase_resume_kmeans(tmp, "cuda", km, wrappers)
        stream = phase_stream(tmp, "cuda", wrappers, torch.Generator(
            device="cuda").manual_seed(SEED + 5))
    if km["launches"]["fused_assign_sum"] != 2 * KMEANS_ITERS:
        raise AssertionError(f"kmeans path launched the kernel "
                             f"{km['launches']} times, expected "
                             f"{2 * KMEANS_ITERS}")
    # the counted runs of both k-means paths: phase 4's and phase 7's
    launches = (km["launches"]["fused_assign_sum"]
                + stream["launches"]["fused_assign_sum"])
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
        "resources": resources,
        "configs": configs + stream["configs"],
    }]
    wc_rate = {name: run["metrics"]["records_in"]
               / run["metrics"]["time/job_s"]
               for name, run in wc["runs"].items()}
    log(f"kmeans ms/iter {km['ms_per_iter']}, resumed "
        f"{km_resume['ms_per_iter']}, kernel ms per call "
        f"{km['kernel_ms']}; stream_device ms/iter "
        f"{ {p: r['ms_per_iter'] for p, r in stream['runs'].items()} }, "
        f"device-resident on that file "
        f"{ {p: r['device_ms_per_iter'] for p, r in stream['runs'].items()} }"
        f"; wordcount words/s {wc_rate}, resumed "
        f"{wc_resume['mapped'] / wc_resume['metrics']['time/job_s']:.0f} "
        f"(tokens mapped in that run over its job time); "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
