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
             6 kernel launches).

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
    resources = build_kernels()
    wrappers = [fused_assign_sum]
    configs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="moxt_smoke_") as tmp:
        km = phase_kmeans(tmp, "cuda", KMEANS_N, KMEANS_D, KMEANS_K,
                          KMEANS_ITERS, wrappers)
        wc = phase_wordcount(tmp, "cuda", CORPUS_BYTES, VOCAB, wrappers)
        wc_resume = phase_resume_wordcount(tmp, "cuda", wc, wrappers)
        km_resume = phase_resume_kmeans(tmp, "cuda", km, wrappers)
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
        "resources": resources,
        "configs": configs,
    }]
    wc_rate = {name: run["metrics"]["records_in"]
               / run["metrics"]["time/job_s"]
               for name, run in wc["runs"].items()}
    log(f"kmeans ms/iter {km['ms_per_iter']}, resumed "
        f"{km_resume['ms_per_iter']}, kernel ms per call "
        f"{km['kernel_ms']}; wordcount words/s {wc_rate}, resumed "
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
