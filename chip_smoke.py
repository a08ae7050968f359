#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to their
plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card and a CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. card      the card's name and power limit (``nvidia-smi``);
2. build     every kernel of the port (``kmeans_assign_sum``,
             ``tokenize_compact``) from the checkout's sources, one
             ``nvcc`` each, all started together, and beside them the
             native C++ host map library with ``g++``; each kernel's
             registers and spills (``-Xptxas -v``) and its HMMA
             (tensor-core) instruction count (``cuobjdump -sass``);
3. kernels   each kernel against its plain version on the card: the
             k-means kernel at the k-means path's shapes, with times (CUDA
             events), the plain version's and one PyTorch library call's
             time, the bound, and the launch plan (blocks per SM, shared
             bytes, resident centroids, partial in shared memory); the
             tokenizer bit-equal on ten 32 MiB chunks (a chunk of phase
             5's corpus, all spaces, one token filling it, a token at
             byte 0, tokens straddling every tile edge, a chunk ending
             inside a token, tokens ending on a tile's or a thread's last
             byte and starting on its first, tokens longer than a tile, a
             token end on every other byte), at fewer row slots than
             tokens, and over 20 repeated launches; with its time, its
             device work per call by kernel (``torch.profiler``), the
             plain version's time, a ``torch.cumsum`` over one int64 plane of
             the chunk as the yardstick, and the bound;
4. kmeans    ``run_job("kmeans")`` on seeded blobs (n=2^22, d=64, k=256,
             10 iterations) in both precisions, launch counts reset just
             before and read just after, each with ``metrics_out`` (its
             ``xprof`` rows, printed in phase 12); each fit's ``attrib/*``
             buckets and
             ``device/compute_ms``, and its ``iterate`` phase over the
             iterations agreeing within 10% with the fit's own timers
             (the one-time transfer plus the iterations) over them;
             then the kernel's own time per call beside the fit's ms/iter,
             and a ``torch.profiler`` trace of two fit steps (device busy
             share, top device ops); one iteration against the NumPy
             oracle ``kmeans_model``;
5. wordcount ``run_job("wordcount")`` on a seeded Zipf corpus (~256 MB, ~1M
             mixed-case words), once with ``mapper='auto'`` (the native C++
             scan in the prefetch thread) and once with ``mapper='python'``,
             both with ``metrics_out`` and ``trace_out``, each against a
             ``collections.Counter`` oracle, the two ``final_result.txt``
             byte-identical; each run's ``attrib/*`` split,
             ``device/compute_ms``, ``feed_block_ms``, ``engine/flush_ms``,
             ``pipeline/*`` and the data audit (no conservation violation),
             ``records_per_sec`` beside words/s over the whole job; a third
             native run with ``data_audit=False``, the audit's price;
6. resume    the same word count killed after 3 chunks and resumed from its
             checkpoint (phase 5's bytes, the prefix replayed, not
             re-mapped); the phase 4 k-means fit in both precisions killed
             after 4 of 10 iterations by an ``on_iter`` that raises, and
             resumed from its snapshot (bit-equal to phase 4's centroids,
             6 kernel launches);
7. stream    the streamed k-means: seeded blobs, n=2^24, d=64, k=512 (a
             4 GiB ``.npy``), ``run_job`` with ``mapper='auto'`` and no fit
             budget set, which must route to ``stream_device``, with B
             pinned to 1; 2 iterations in each precision (3 before
             phase 16 joined the script; the pinned
             reference of phase 12), launch counts reset just before
             and read just after (one launch per chunk per iteration),
             ms/iter, host-to-device bytes and GB/s, ``feed_wait_s`` and
             ``overlap_ratio``, the ``attrib/*`` buckets and
             ``device/compute_ms``, the ``iterate`` phase agreeing with the
             ms/iter within 10%; three stager schedules in turns (depth
             2 with B=1 as counted, the serial depth 1, and B=8; one
             iteration each, two rounds), bit-equal, with their ms/iter;
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
             uninterrupted streamed fit;
8. obs       a small k-means (n=2^16, d=64, k=256) with ``trace_dir``,
             run after phase 3 as the process's first profiler capture:
             its ``torch.profiler`` trace must name the kernel
             (``kmeans_assign_sum``); after phase 7, the same fit with an
             ``on_iter`` that raises, with ``crash_dir``, ``metrics_out``
             and ``trace_out``: the crash bundle and the partial metrics
             and trace must be on disk, the phase span closed with the
             error; then the ``trace_dir`` fit once more, its trace's
             contents logged;
9. collect   the collect route on phase 5's corpus: bigram on its first
             16 MB through ``mapper='auto'`` (the host collect, hash-only,
             strings by the native rescan) and ``reduce_mode='fold'`` on
             the card (``key_capacity`` above the distinct count), the two
             ``final_result.txt`` byte-identical; the inverted index on
             its first 128 MB with the host sort (``auto``), the card sort (the
             pairs on the card, one sort timed alone with CUDA events,
             then three warm sorts of the same block) and a forced
             demotion to disk buckets, the three postings files
             byte-identical, and on a 16 MB prefix equal to
             ``inverted_index_model``; distinct on the whole corpus beside
             phase 5's exact distinct count, and the native and Python
             maps' registers equal on a 4 MB prefix; the inverted index of
             the 16 MB prefix (4 chunks) killed after 3 and resumed to the
             same bytes.  Words/s,
             ``attrib/*``, phases, ``demote/*`` and the phase's wall are
             printed; no hand kernel is on this route (its launch count
             stays 0);
10. dataflow sort of 2^25 seeded (key, payload) records (512 MiB) with
             the host sort, the card sort and a forced demotion to disk
             buckets (``collect_max_rows`` at a third of the rows,
             ``hybrid``), the three outputs byte-identical and equal to
             ``sort_model``; join of 2^22 x 2^22 rows over 2^22 keys with
             both sorts, equal to ``join_model``; sessionize of 2^24 events
             over 2^20 keys (gap 3600) with the card sort, equal to
             ``sessionize_model``.  For each run rows/s over the job, its
             phases, ``attrib/*`` (``host_sort`` among them) and the card
             sort's own time (CUDA events);
11. devmap   ``run_job("wordcount")`` with ``mapper='device'`` on phase 5's
             corpus, launch counts reset just before and read just after
             (one ``tokenize_compact`` launch per chunk), its
             ``final_result.txt`` byte-identical to phase 5's native run,
             words/s, ``attrib/*`` and a ``torch.profiler`` window over a
             3-chunk prefix (device busy share, the host-to-device copies'
             GB/s); bigram with ``mapper='device'`` on phase 9's 16 MB
             prefix as one chunk (``device_chunk_keys`` reckoned from phase
             9's distinct bigrams), byte-identical to the native bigram at
             the same chunking; a device-map word count in 8 MiB chunks
             killed past its first snapshot and resumed, byte-identical;
12. plan     the dispatch-batch resolver and the job planner on phase 7's
             file (n=2^24, d=64, k=512) in both precisions, phase 7's 3
             iterations per fit: the card's sustained bf16 matmul rate
             (``torch.matmul`` at 8192^3) and device copy rate, beside its
             name and power limit; a cold ``stream_device`` fit
             (``dispatch_batch=0``, ``plan='auto'``, an empty ``calib_dir``,
             the launch ledger and the resolver's memo reset as in a fresh
             process) with its B, rule, floor and compute sources and
             ``hbm_cap``, its ms/iter beside phase 7's B=1 and B=8; a warm
             fit on the same ``calib_dir`` (the plan's ``curve``
             provenance, predicted wall, ``plan/model_error_pct``); both
             bit-equal to phase 7's pinned B=1 fit; the ``xprof`` rows of
             ``kmeans/stream_step``, phase 4's ``kmeans/fit`` and phase 6's
             ``kmeans/step`` (dispatches, sampled device ms, achieved
             rates, the share of the measured peaks, the bound); launch
             counts reset just before and read just after;
13. serve    the resident job service: ``python -m map_oxidize_tpu_torch
             serve`` as a subprocess (``--port 0``, two workers, a spool
             in the temporary directory), driven over HTTP through
             ``ServeClient``: its warm-up's ``hbm/budget_bytes`` equal to
             the card's total memory; a cold and a warm k-means job on
             phase 4's file, both bit-equal to phase 4's ``run_job``, the
             warm one with 0 compiles, ``serve/warm_compiles`` 0 and no
             ``warm-serve-recompile`` alert, ``hbm/live_bytes_device0 > 0``
             while the cold one runs; two word counts at once on phase 5's
             corpus (the native map and the device map), each
             byte-identical to phase 5's, the device job's
             ``device_map/tokenize`` dispatches equal to its chunks, their
             words/s and ``device/compute_ms`` beside their solo runs
             (phases 5 and 11); a 2 s ``POST /profile`` capture during a
             bf16 k-means job whose device trace names
             ``kmeans_assign_sum``; an oversized submission rejected with
             admission's named reason; the key sets of ``/healthz``,
             ``/status``, ``/metrics``, ``/series``, ``/alerts`` and
             ``/jobs``; the server process's kernel launch counts
             (``kernels/<name>/launches``, from 0 at its start); a
             ``POST /shutdown`` drain: exit 0, ``obs_port.json`` removed,
             one ledger entry per done job.  Each job's submit-to-done
             latency, queue wait and run wall.  Before the drain, phase
             14's fleet step;
14. obs      the offline ``obs`` tooling on card documents: phase 4's
             k-means (``highest``) three times and phase 11's device-map
             word count twice, each through the port's CLI ``main`` in a
             fresh process (``--backend cuda``, ``--ledger-dir``,
             ``--calib-dir``, ``--metrics-out``; phase 12's measured peaks
             in ``MOXT_PEAK_FLOPS`` / ``MOXT_PEAK_MEMBW``) that prints its
             kernel launch counts, bit-equal to phase 4 / byte-identical
             to phase 5; then ``python -m map_oxidize_tpu_torch obs ...``
             as subprocesses, each timed: ``xprof`` (``kmeans/fit`` and
             ``device_map/tokenize`` with achieved rates and MFU),
             ``where`` (buckets + unattributed = wall), ``plan``,
             ``data`` (on phase 5's native word count: the device map
             keeps no audit, exit 2), ``critpath``, ``calib show``,
             ``diff``, ``diff
             --gate`` on a copy of the ledger with the last
             ``time/iterate_s`` doubled (exit 3), ``trend`` plain and
             ``--json``, ``flame`` on phase 13's capture bundle (naming an
             attribution bucket) and ``xprof`` on phase 8's crash bundle.
             The fleet step runs inside phase 13 before its drain: a
             served bf16 k-means of 2,000 iterations and a one-shot card
             k-means of 1,500 with its live plane (``--obs-port 0``)
             under ``obs fleet --spool <the server's spool> --port-file
             <the job's MOXT_OBS_PORT_FILE>`` (32 sweeps at 0.25 s,
             archiving), whose ``/metrics`` carries both as labelled
             targets, the server with its device-memory gauges, while
             the server reports ``kernels/kmeans_assign_sum/launches``;
             ``obs top --url`` renders the per-target table; after the
             collector exits, ``obs top/where/trend/critpath --archive``
             name the targets (``where`` and ``critpath`` the job: a
             resident server's own bundle has no attribution).

15. sharded  the sharded engines (ROADMAP A7) on 8 virtual slots on
             ``cuda:0``: phase 5's word count at S=8 over ``all_to_all``,
             byte-identical to phase 5; its 32 MB prefix under
             ``all_to_all`` and ``all_gather``, byte-identical; phase 4's
             k-means at S=8 in both precisions, twice (counts equal to
             phase 4's, centroids within 1e-5 * max|x|, the two runs
             bit-equal, the kernel once per shard per iteration); one
             ``stream_device`` iteration of phase 7's file at S=8; phase
             10's sort at S=8 over the range splitters, byte-identical;
             phase 11's device-map word count at S=8, byte-identical (one
             ``tokenize_compact`` launch per shard per group); an S=8
             word count of the prefix killed after 3 chunks and resumed;
             ``obs calib probe --num-shards 8`` into a fresh store at the
             payload bucket of a planned S=8 job, whose
             ``plan/exchange_collective`` then reads ``curve``.  Each run
             prints its wall, ``attrib/*`` split, ``shuffle/*`` bytes,
             comm rows, the exchange's and the fold's device time (CUDA
             events around each call) and both kernels' launches.
16. dist     the multi-process drivers (ROADMAP A8) on one card: each run
             starts two CLI processes (``python -m map_oxidize_tpu_torch
             ... --num-shards 8 --dist-coordinator 127.0.0.1:<free port>
             --dist-processes 2 --dist-process-id i``, through a wrapper
             that prints the process's kernel launches, Gloo bytes and
             peak device memory), each with 4 virtual slots on
             ``cuda:0``, the spawn retried once on a fresh port: phase
             5's word count (the two ``.part`` files, concatenated and
             sorted, byte-identical to phase 5's ``final_result.txt``;
             the printed top-k phase 5's); phase 4's k-means in both
             precisions (counts equal to phase 15's S=8 fit, centroids
             within 1e-5 * max|x|, the two processes bit-equal, 10 x 4
             ``kmeans_assign_sum`` launches each); phase 10's sort (the
             parts, process-major, byte-identical to its card sort); the
             remote-staged word count of the 32 MB prefix with process 1
             SIGKILLed after its first committed manifest (process 0
             claims and recovers it; the parts equal phase 15's bytes);
             ``obs merge`` and ``obs critpath`` over the word count's
             trace shards.  Each job's wall, words/s or rows/s beside
             phase 15's, the ``comms`` bytes and each process's peak
             device memory.

Then one JSON line with every kernel, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Inputs are made from fixed
seeds in a temporary directory, which is removed at the end.
"""

from __future__ import annotations

import collections
import json
import os
import re
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
STREAM_N, STREAM_K, STREAM_ITERS = 1 << 24, 512, 2
OBS_N = 1 << 16         # the small fit of phase 8
SCHEDULE_ITERS = 1      # iterations per run of the stager schedules
HOST_N, HOST_K = 1 << 20, 64               # the host-assign stream
RESUME_N, RESUME_ITERS, RESUME_KILL_AFTER = 1 << 22, 5, 2
BIGRAM_BYTES = 16 << 20   # the prefix both bigram runs of phase 9 take
BIGRAM_CHUNK = 8 << 20
II_BYTES = 128 << 20        # the prefix of phase 9's three index runs
II_MODEL_BYTES = 16 << 20  # the prefix held to inverted_index_model
DISTINCT_PY_BYTES = 4 << 20  # the prefix the Python HLL map takes
II_KILL_AFTER = 3
TOKENIZE_REPEATS = 20     # launches on one chunk that must agree
SORT_N = 1 << 25          # phase 10: records of the sort (512 MiB)
JOIN_N, JOIN_KEYS = 1 << 22, 1 << 22
SESS_N, SESS_KEYS, SESS_GAP = 1 << 24, 1 << 20, 3600
SESS_SPAN = 86400         # timestamps over one day: ~16 events per key
DEVMAP_SNAP_CHUNK = 8 << 20  # phase 11's killed run: 32 chunks, snapshots
DEVMAP_KILL_AFTER = 17       # at 16 and 32; the kill is past the first
DEVMAP_PROFILE_CHUNKS = 3


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def attrib_line(m: dict) -> str:
    """A job's wall attribution (``attrib/*``, ms) and its blocking device
    fetches (``device/compute_ms``), from its metrics."""
    from map_oxidize_tpu_torch.obs.attrib import BUCKETS

    buckets = ", ".join(f"{b} {m[f'attrib/{b}_ms']:.1f}"
                        for b in BUCKETS if m[f"attrib/{b}_ms"])
    fetches = (f"{m['device/compute_ms/count']} fetches, p50 "
               f"{m['device/compute_ms/p50']:.3f}, max "
               f"{m['device/compute_ms/max']:.3f}, total "
               f"{m['attrib/device_compute_ms']:.3f}"
               if "device/compute_ms/count" in m else "no fetch")
    return (f"wall {m['attrib/wall_ms']:.1f} ms: {buckets}, unattributed "
            f"{m['attrib/unattributed_ms']:.1f} "
            f"({m['attrib/unattributed_pct']}%); device/compute_ms "
            f"{fetches}")


def check_iterate(name: str, m: dict, iters: int, own_s: float,
                  own: str) -> float:
    """The ``iterate`` phase over the iterations against the fit's own
    timers over the same iterations (``own_s``: what the fit measures of
    the phase, e.g. its one-time transfer plus its iterations): within
    10%.  Logs the phase's time outside the fit's timers."""
    phase_ms = m["time/iterate_s"] / iters * 1e3
    own_ms = own_s / iters * 1e3
    log(f"{name}: iterate phase {m['time/iterate_s']:.4f} s = "
        f"{phase_ms:.3f} ms/iter against the fit's {own} {own_s:.4f} s = "
        f"{own_ms:.3f} ms/iter ({phase_ms / own_ms - 1:+.1%}; "
        f"{(m['time/iterate_s'] - own_s) * 1e3:.1f} ms of the phase outside "
        "the fit's timers)")
    if abs(phase_ms - own_ms) > 0.1 * own_ms:
        raise AssertionError(f"{name}: the iterate phase ({phase_ms:.3f} "
                             f"ms/iter) and the fit ({own_ms:.3f}) differ "
                             "by more than 10%")
    return phase_ms


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
    tag = "16tokenize_compact"  # the namespace's length-prefixed name
    at = mangled.find(tag)
    if at >= 0:
        digits = re.match(r"\d+", mangled[at + len(tag):])
        if digits:
            start = at + len(tag) + len(digits.group())
            return ("tokenize_compact "
                    + mangled[start:start + int(digits.group())])
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


def tokenize_chunks(path: str, layout: dict) -> list[tuple[str,
                                                         np.ndarray]]:
    """The padded ``CHUNK_BYTES`` chunks phase 3 holds the tokenizer to its
    plain version on: corpus text, corner cases, and tokens on the edges of
    the built kernel's tiles and threads (``layout``)."""
    from map_oxidize_tpu_torch.io.splitter import iter_chunks_capped
    from map_oxidize_tpu_torch.ops.device_tokenize import pad_chunk

    n, tile, per = CHUNK_BYTES, layout["tile"], layout["bytes_per_thread"]
    corpus = pad_chunk(bytes(next(iter_chunks_capped(path, n))), n).copy()
    head = np.full(n, 32, np.uint8)
    head[0] = ord("A")
    edges = np.full(n, 32, np.uint8)
    for e in range(tile, n, tile):
        edges[e - 3:e + 2] = np.frombuffer(b"TiLeX", np.uint8)
    for e in range(per, n, per * 37):  # thread edges, every 37th
        edges[e - 1:e + 1] = np.frombuffer(b"zq", np.uint8)
    ends_inside = corpus.copy()
    ends_inside[-9:] = np.frombuffer(b"unfinishe", np.uint8)
    # tokens ending on a tile's last byte, then starting on its first
    tile_aligned = np.full(n, 32, np.uint8)
    for e in range(tile, n, tile):
        if e < n // 2:
            tile_aligned[e - 5:e] = np.frombuffer(b"EnDsT", np.uint8)
        else:
            tile_aligned[e:e + 5] = np.frombuffer(b"StArT", np.uint8)
    # every thread's last byte a space, then every thread's first byte
    threads = np.full(n, ord("t"), np.uint8)
    threads[per - 1:n // 2:per] = 32
    threads[n // 2::per] = 32
    # tokens longer than a tile, so some tiles lie inside one token
    long_tokens = np.full(n, ord("L"), np.uint8)
    long_tokens[3 * tile // 2 + 7::3 * tile // 2 + 8] = 32
    # the most rows a tile can hold: a token end on every other byte
    dense = np.full(n, 32, np.uint8)
    dense[: n // 2:2] = ord("d")
    dense[n // 2 + 1::2] = ord("o")
    return [("corpus", corpus), ("all spaces", np.full(n, 32, np.uint8)),
            ("one token", np.full(n, ord("w"), np.uint8)),
            ("token at byte 0", head), ("tile edges", edges),
            ("ends inside a token", ends_inside),
            ("tokens on tile bounds", tile_aligned),
            ("tokens on thread bounds", threads),
            ("tokens longer than a tile", long_tokens),
            ("a row every other byte", dense)]


def check_tokenize(name: str, chunk, max_tokens: int) -> tuple[int, float]:
    """One ``tokenize_compact`` call against ``tokenize_compact_plain``,
    every output bit-equal; returns the token count and the largest
    absolute difference of any output (0 when they agree)."""
    import torch

    from map_oxidize_tpu_torch.ops.device_tokenize import (
        tokenize_compact,
        tokenize_compact_plain,
    )

    got = tokenize_compact(chunk, max_tokens)
    want = tokenize_compact_plain(chunk, max_tokens)
    torch.cuda.synchronize()
    err = max(float((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err or not all(g.dtype == w.dtype and torch.equal(g, w)
                      for g, w in zip(got, want)):
        raise AssertionError(f"tokenize_compact != plain on {name!r} at "
                             f"max_tokens={max_tokens}")
    return int(got[3]), err


def tokenize_split(chunk, max_tokens: int, calls: int = 10) -> dict:
    """The device work of one ``tokenize_compact`` call, by name, from
    ``torch.profiler`` over ``calls`` calls: launches per call and device
    ms per call of each kernel (``tokenize_compact::<kernel>``) and each
    other device op (the scratch's memset)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact

    tokenize_compact(chunk, max_tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            tokenize_compact(chunk, max_tokens)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        split[e.key.split("(")[0]] = {
            "per_call": e.count / calls,
            "ms": e.self_device_time_total / calls / 1e3}
    return split


def phase_tokenize_kernel(path: str, resources: dict) -> dict:
    """``tokenize_compact`` against ``tokenize_compact_plain`` on the card,
    bit-equal on every chunk of :func:`tokenize_chunks`, at fewer row slots
    than tokens, and over repeated launches; on the corpus chunk the
    kernel's time, its split by kernel (``torch.profiler``), the plain
    version's time, the ``torch.cumsum`` yardstick and the bound."""
    import torch

    from map_oxidize_tpu_torch.ops.device_tokenize import (
        built_layout,
        tokenize_compact,
        tokenize_compact_plain,
    )

    n = CHUNK_BYTES
    max_tokens = n // 2 + 1
    layout = built_layout()
    out = {"n": n, "max_tokens": max_tokens, "checked": [], "layout": layout}
    errs = []
    for name, arr in tokenize_chunks(path, layout):
        chunk = torch.from_numpy(arr).cuda()
        n_tok, err = check_tokenize(name, chunk, max_tokens)
        errs.append(err)
        out["checked"].append((name, n_tok))
        log(f"tokenize_compact {name}: {n_tok} tokens, bit-equal to the "
            "plain version")
        if name in ("corpus", "a row every other byte"):
            # fewer row slots than tokens, off the 16-byte store width
            for few in (n_tok // 2 + 3, n_tok - 1):
                errs.append(check_tokenize(name, chunk, few)[1])
                out["checked"].append((f"{name} max_tokens={few}", n_tok))
            log(f"tokenize_compact {name}: bit-equal at max_tokens "
                f"{n_tok // 2 + 3} and {n_tok - 1}")
            first = tokenize_compact(chunk, max_tokens)
            for _ in range(TOKENIZE_REPEATS - 1):
                again = tokenize_compact(chunk, max_tokens)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"tokenize_compact on {name!r}: a "
                                         "repeated launch differs")
            log(f"tokenize_compact {name}: {TOKENIZE_REPEATS} launches, "
                "the same bits")
        if name == "corpus":
            out["ms"] = time_ms(lambda: tokenize_compact(chunk, max_tokens),
                                reps=20)
            out["split"] = tokenize_split(chunk, max_tokens)
            out["plain_ms"] = time_ms(
                lambda: tokenize_compact_plain(chunk, max_tokens), reps=3,
                warmup=1)
            plane = chunk.to(torch.int64)
            out["yardstick_ms"] = time_ms(lambda: torch.cumsum(plane, 0),
                                          reps=5, warmup=1)
            del plane
        del chunk
        torch.cuda.empty_cache()
    out["max_abs_err"] = max(errs)  # over every output of every check
    # the chunk read once, the padded rows and the count written once
    nbytes = n + 12 * max_tokens + 4
    out["bound_ms"] = nbytes / PEAK_BYTES * 1e3
    out["bound_by"] = "bytes"
    out["yardstick"] = ("torch.cumsum over one int64 plane of the chunk "
                        "(a yardstick: no PyTorch call tokenizes)")
    out["launches_per_call"] = {k: v["per_call"]
                                for k, v in out["split"].items()}
    out["resources"] = {k: v for k, v in resources.items()
                        if k.startswith("tokenize_compact")}
    split = ", ".join(f"{k} {v['ms']:.4f} ms x{v['per_call']:g}"
                      for k, v in out["split"].items())
    log(f"tokenize_compact {n >> 20} MiB: kernel {out['ms']:.4f} ms "
        f"({out['bound_ms'] / out['ms']:.1%} of the bound "
        f"{out['bound_ms']:.4f} ms, {nbytes} bytes; "
        f"{out['ms'] / out['yardstick_ms']:.2f}x the torch.cumsum "
        f"yardstick {out['yardstick_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.3f} ms; device work per call: {split}; "
        f"resources {out['resources']}; layout {layout} (dynamic shared "
        "bytes per block beside the static bytes ptxas reports)")
    return out


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

    def cfg(precision, n_iters, out, **kw):
        return JobConfig(input_path=path, output_path=out, backend=backend,
                         kmeans_k=k, kmeans_iters=n_iters,
                         kmeans_precision=precision, metrics=False, **kw)

    for w in wrappers:
        w.launches = 0
    runs, xprof = {}, {}
    for precision in ("highest", "bf16"):
        out = os.path.join(tmp, f"centroids_{precision}.npy")
        doc = os.path.join(tmp, f"kmeans_{precision}.json")
        r = run_job(cfg(precision, iters, out, metrics_out=doc), "kmeans")
        runs[precision] = r
        with open(doc) as f:
            xprof[precision] = json.load(f)["xprof"]
        log(f"kmeans {precision}: {iters} iterations in "
            f"{r.metrics['time/iter_s']:.4f} s "
            f"({r.metrics['time/iter_s'] / iters * 1e3:.3f} ms/iter), "
            f"transfer {r.metrics['time/transfer_s']:.3f} s, "
            f"device {r.metrics['device']}; {attrib_line(r.metrics)}")
        check_iterate(f"kmeans {precision}", r.metrics, iters,
                      r.metrics["time/transfer_s"] + r.metrics["time/iter_s"],
                      "transfer + iterations")
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
            "centroids": {p: r.centroids for p, r in runs.items()},
            "xprof": xprof, **prof}


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


def job_s(m: dict) -> float:
    """A job's wall in seconds (``attrib/wall_ms``)."""
    return m["attrib/wall_ms"] / 1e3


def wordcount_line(name: str, m: dict, launches: dict,
                   mapped: int | None = None) -> str:
    """One run's counts, times and rates; ``mapped``, for a resumed run, is
    the tokens of the chunks it mapped (not replayed), which its words/s
    counts.  ``records_per_sec`` is the registry's: records over
    map+reduce and finalize."""
    mapped = m["records_in"] if mapped is None else mapped
    return (f"wordcount {name}: {m['records_in']} tokens, "
            f"{m['distinct_keys']} distinct, {m['chunks']} chunks "
            f"({m.get('checkpoint/chunks_replayed', 0)} replayed), job "
            f"{job_s(m):.2f} s ({mapped} tokens mapped in this run, "
            f"{mapped / job_s(m):.0f} words/s over the job; "
            f"records_per_sec {m['records_per_sec']}), "
            f"split {m['time/split_s']:.2f} s, "
            f"map+reduce {m['time/map+reduce_s']:.2f} s, "
            f"finalize {m['time/finalize_s']:.2f} s, write "
            f"{m['time/write_s']:.2f} s, accumulator on "
            f"{m['accumulator_device']} at "
            f"{m.get('engine/capacity_rows', 'its initial')} rows; "
            f"launches {launches}")


def wordcount_obs_line(name: str, m: dict) -> str:
    """The seams of one word count: the wall attribution, the device
    fetch, the per-block feed, the flushes and the pipeline."""
    return (f"wordcount {name} seams: {attrib_line(m)}; feed_block_ms "
            f"{m['feed_block_ms/count']} feeds p50 "
            f"{m['feed_block_ms/p50']:.3f} max {m['feed_block_ms/max']:.3f} "
            f"(host_stage {m['attrib/host_stage_ms']:.1f} ms total); "
            f"engine/flush_ms {m['engine/flushes']} flushes p50 "
            f"{m['engine/flush_ms/p50']:.3f} max "
            f"{m['engine/flush_ms/max']:.3f}, "
            f"{m['engine/device_put_bytes']} bytes put; pipeline depth "
            f"{m.get('pipeline/depth')}, {m.get('pipeline/chunks')} chunks, "
            f"produce {m.get('pipeline/produce_ms', 0.0):.1f} ms, feed_wait "
            f"{m.get('pipeline/feed_wait_ms', 0.0):.1f} ms, overlap_ratio "
            f"{m.get('pipeline/overlap_ratio')}")


def write_corpus(tmp: str, nbytes: int, vocab: int) -> str:
    """Phase 5's corpus in the temporary directory (phase 3's tokenizer
    check takes its first chunk)."""
    t0 = time.perf_counter()
    data = make_corpus(nbytes, vocab, SEED + 2)
    path = os.path.join(tmp, "corpus.txt")
    with open(path, "wb") as f:
        f.write(data)
    log(f"corpus: {len(data)} bytes ({time.perf_counter() - t0:.1f} s to "
        "make)")
    return path


def phase_wordcount(tmp: str, backend: str, path: str, wrappers) -> dict:
    """The corpus through ``mapper='auto'`` (which must resolve to the
    native C++ mapper) and ``mapper='python'``: each against the Counter
    oracle and its top-10, the two outputs byte-identical."""
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import resolve_mapper, run_job

    t0 = time.perf_counter()
    data = read(path)
    oracle = collections.Counter(data.lower().split())
    want_top = sorted(oracle.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    del data
    log(f"Counter oracle: {len(oracle)} distinct "
        f"({time.perf_counter() - t0:.1f} s)")
    runs = {}
    for mapper in ("auto", "python"):
        out = os.path.join(tmp, f"final_result_{mapper}.txt")
        m_out = os.path.join(tmp, f"wc_metrics_{mapper}.json")
        t_out = os.path.join(tmp, f"wc_trace_{mapper}.json")
        cfg = JobConfig(input_path=path, output_path=out, backend=backend,
                        chunk_bytes=CHUNK_BYTES, top_k=10, mapper=mapper,
                        metrics=False, metrics_out=m_out, trace_out=t_out)
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
        log(wordcount_obs_line(resolved, m))
        check_wordcount_documents(resolved, m, m_out, t_out)
        if not m["accumulator_device"].startswith(backend):
            raise AssertionError(f"accumulator on {m['accumulator_device']}")
        if m["engine/capacity_rows"] <= JobConfig.initial_key_capacity:
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

    # the audit's price: the native run again with data_audit off
    out = os.path.join(tmp, "final_result_no_audit.txt")
    r = run_job(JobConfig(input_path=path, output_path=out, backend=backend,
                          chunk_bytes=CHUNK_BYTES, top_k=10, metrics=False,
                          data_audit=False), "wordcount")
    m = r.metrics
    if any(key.startswith("data/") for key in m):
        raise AssertionError("data_audit=False still audited")
    with open(out, "rb") as f:
        if f.read() != native_bytes:
            raise AssertionError("the run without the audit wrote other "
                                 "bytes")
    on = runs["native"]["metrics"]
    log(wordcount_line("native, data_audit=False", m, {}))
    log(wordcount_obs_line("native, data_audit=False", m))
    log(f"the data audit's price: native {on['records_in'] / job_s(on):.0f} "
        f"words/s with it, {m['records_in'] / job_s(m):.0f} without "
        f"(map+reduce {on['time/map+reduce_s']:.2f} s against "
        f"{m['time/map+reduce_s']:.2f} s)")
    runs["native_no_audit"] = {"metrics": m, "out": out}
    return {"path": path, "runs": runs, "top": want_top}


def check_wordcount_documents(name: str, m: dict, m_out: str,
                              t_out: str) -> None:
    """The ``metrics_out`` document carries the registry, ``meta``,
    ``attrib`` and ``data`` sections, the audit found no violation, and
    the ``trace_out`` trace holds the phases in order after its
    ``moxt_meta`` event."""
    with open(m_out) as f:
        doc = json.load(f)
    missing = {"phases_s", "counters", "gauges", "histograms", "meta",
               "attrib", "data"} - set(doc)
    if missing:
        raise AssertionError(f"wordcount {name}: metrics_out lacks {missing}")
    if (m["data/conservation_violations"] != 0
            or m["data/conservation_checks"] != 3
            or doc["data"]["conservation"]["violations"]):
        raise AssertionError(f"wordcount {name}: data audit "
                             f"{doc['data']['conservation']}")
    with open(t_out) as f:
        trace = json.load(f)
    phases = [e["name"] for e in trace if e["name"].startswith("phase/")]
    if trace[0]["name"] != "moxt_meta" or phases != [
            "phase/split", "phase/map+reduce", "phase/finalize",
            "phase/write"]:
        raise AssertionError(f"wordcount {name}: trace phases {phases}")
    log(f"wordcount {name}: metrics_out and trace_out written "
        f"({len(trace)} trace events); data audit: "
        f"{m['data/conservation_checks']} checks, "
        f"{m['data/conservation_violations']} violations, "
        f"{m['data/rows_in']} map rows in, {m['data/distinct_out']} keys "
        f"out (reduction {m['data/reduction_ratio']}), imbalance "
        f"{m['data/imbalance_factor']}, hot-key share "
        f"{m['data/hot_key_share']}")


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
    if m.get("checkpoint/chunks_replayed") != WC_KILL_AFTER:
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
        cfg.metrics_out = os.path.join(tmp, f"km_resume_{precision}.json")
        r = run_job(cfg, "kmeans")
        launches = {w.__name__: w.launches for w in wrappers}
        with open(cfg.metrics_out) as f:
            out.setdefault("xprof", {})[precision] = json.load(f)["xprof"]
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

    out = {"chunk_rows": chunk_rows, "n_chunks": n_chunks, "path": path,
           "runs": {}, "configs": []}
    for w in wrappers:
        w.launches = 0
    for precision in ("highest", "bf16"):
        r = run_job(cfg(precision, STREAM_ITERS, dispatch_batch=1), "kmeans")
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
            f"{m['dispatch/batch']}; {attrib_line(m)}")
        check_iterate(f"stream_device {precision}", m, STREAM_ITERS,
                      m["time/feed_s"], "block loop")
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
    # (B pinned; phase 12 runs the auto resolution); all give the same bits
    schedules = (("depth 2, B 1", dict(dispatch_batch=1)),
                 ("depth 1, B 1", dict(pipeline_depth=1, dispatch_batch=1)),
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
    out["max_abs"] = float(np.abs(pts).max())
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
    out["host"] = {"ms_per_iter": m["time/iterate_s"] * 1e3,
                   "overlap_ratio": m.get("pipeline/overlap_ratio"),
                   "second_ms_per_iter":
                       host[1].metrics["time/iterate_s"] * 1e3}
    log(f"stream (host assign, n={HOST_N}, k={HOST_K}): "
        f"{m['time/iterate_s'] * 1e3:.3f} ms/iter "
        f"(second run {out['host']['second_ms_per_iter']:.3f}), "
        f"overlap_ratio {m.get('pipeline/overlap_ratio')}; "
        f"{attrib_line(m)}; matches "
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


# --- phase 8 ----------------------------------------------------------------

def obs_points(tmp: str) -> str:
    """The small fit's points (n=2^16, d=64, k=256), made once."""
    path = os.path.join(tmp, "obs_points.npy")
    if not os.path.exists(path):
        np.save(path, make_blobs(OBS_N, KMEANS_D, KMEANS_K, SEED + 6))
    return path


def obs_config(tmp: str, backend: str, **kw):
    from map_oxidize_tpu_torch.config import JobConfig

    return JobConfig(input_path=obs_points(tmp), output_path="",
                     backend=backend, kmeans_k=KMEANS_K, kmeans_iters=3,
                     mapper="device", metrics=False, **kw)


def trace_dir_kernels(tmp: str, backend: str, name: str) -> list:
    """The small fit with ``trace_dir``: the device kernel events of its
    ``torch.profiler`` trace that name ``kmeans_assign_sum``."""
    from map_oxidize_tpu_torch.runtime import run_job

    prof_dir = os.path.join(tmp, name)
    r = run_job(obs_config(tmp, backend, trace_dir=prof_dir), "kmeans")
    (f,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, f)) as fh:
        events = json.load(fh)["traceEvents"]
    cats = collections.Counter(e.get("cat", "-") for e in events)
    kern = [e for e in events if "kmeans_assign_sum" in e.get("name", "")]
    log(f"trace_dir ({name}): {len(events)} events in {f} "
        f"(profile/captures {r.metrics.get('profile/captures')}), by "
        f"category {dict(cats)}; {len(kern)} name kmeans_assign_sum"
        + (f", e.g. {kern[0]['name'][:60]!r}" if kern else ""))
    return kern


def phase_trace_dir(tmp: str, backend: str) -> None:
    """Phase 8, first half, run before any other profiler capture of the
    process: the small fit's ``trace_dir`` trace must name the kernel."""
    if not trace_dir_kernels(tmp, backend, "profile"):
        raise AssertionError("trace_dir: no event names kmeans_assign_sum")


def phase_flight(tmp: str, backend: str) -> None:
    """Phase 8, second half: the small fit killed by an ``on_iter`` that
    raises after its first iteration, with ``crash_dir``, ``metrics_out``
    and ``trace_out``: the bundle and the partial documents must be on
    disk."""
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads import kmeans as tkm

    real_fit = tkm.kmeans_fit_device

    def dying_fit(*a, on_iter=None, **kw):
        def hook(i, c):
            if i == 1:
                raise KeyboardInterrupt("simulated kill")
        return real_fit(*a, on_iter=hook, **kw)

    crash = os.path.join(tmp, "crash")
    m_out = os.path.join(tmp, "crash_metrics.json")
    t_out = os.path.join(tmp, "crash_trace.json")
    tkm.kmeans_fit_device = dying_fit
    try:
        run_job(obs_config(tmp, backend, crash_dir=crash, metrics_out=m_out,
                           trace_out=t_out), "kmeans")
        raise AssertionError("the raising fit ran to its end")
    except KeyboardInterrupt:
        pass
    finally:
        tkm.kmeans_fit_device = real_fit
    (bundle,) = os.listdir(crash)
    files = sorted(os.listdir(os.path.join(crash, bundle)))
    with open(m_out) as f:
        doc = json.load(f)
    with open(t_out) as f:
        trace = json.load(f)
    it = [e for e in trace if e["name"] == "phase/iterate"]
    if (files != ["error.json", "metrics.json", "trace.json"]
            or doc["gauges"].get("aborted") is not True
            or "attrib" not in doc or len(it) != 1
            or "simulated kill" not in it[0]["args"].get("error", "")):
        raise AssertionError(f"flight recorder: bundle {files}, metrics "
                             f"{sorted(doc)}, iterate span {it}")
    log(f"flight recorder: {bundle}/{files}; partial metrics (aborted, "
        f"wall {doc['attrib']['wall_ms']:.1f} ms) and trace "
        f"({len(trace)} events, phase/iterate closed with "
        f"{it[0]['args']['error']!r}) on disk")
    # the same trace_dir job once more, after the process's other profiler
    # captures (phases 4 and 7): what its trace holds is logged
    trace_dir_kernels(tmp, backend, "profile_late")


# --- phase 9 ----------------------------------------------------------------

def prefix_file(src: str, dst: str, nbytes: int) -> str:
    """The first ``nbytes`` of ``src``, cut after its last newline."""
    with open(src, "rb") as f:
        head = f.read(nbytes)
    with open(dst, "wb") as f:
        f.write(head[:head.rfind(b"\n") + 1])
    return dst


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def collect_line(name: str, m: dict) -> str:
    """One collect-route job's counts, phases and rates."""
    phases = ", ".join(f"{k[5:-2]} {v:.2f} s" for k, v in m.items()
                       if k.startswith("time/") and k.endswith("_s"))
    demote = {k: v for k, v in m.items()
              if k.startswith(("demote/", "spill/"))}
    return (f"{name}: {m['records_in']} tokens, job {job_s(m):.2f} s, "
            f"{m['records_in'] / job_s(m):.0f} words/s over the job; "
            f"{phases}; shuffle/transport {m.get('shuffle/transport')}; "
            f"{demote or 'no demotion'}; {attrib_line(m)}")


def phase_collect(tmp: str, backend: str, wc: dict, wrappers) -> dict:
    """The collect route on phase 5's corpus (module docstring, phase 9):
    bigram through the hash-only collect and through the fold on the card
    (a prefix), the inverted index with the host sort, the card sort and a
    forced demotion, distinct, and the inverted index killed and
    resumed."""
    import torch

    import map_oxidize_tpu_torch.runtime.collect as collect_mod
    import map_oxidize_tpu_torch.runtime.driver as driver_mod
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.io.writer import write_postings
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads.distinct import distinct_model
    from map_oxidize_tpu_torch.workloads.inverted_index import (
        inverted_index_model,
    )

    t_phase = time.perf_counter()
    path = wc["path"]
    for w in wrappers:
        w.launches = 0
    out: dict = {"bigram": {}, "invertedindex": {}}

    # bigram: the auto route (collect, hash-only, the native rescan) and
    # the fold on the card, on a prefix of the corpus
    bpath = prefix_file(path, os.path.join(tmp, "bigram_corpus.txt"),
                        BIGRAM_BYTES)
    key_capacity = 0
    for name, kw in (("auto", {}), ("fold", {"reduce_mode": "fold"})):
        o = os.path.join(tmp, f"bigram_{name}.txt")
        if name == "fold":
            kw["key_capacity"] = key_capacity
        r = run_job(JobConfig(input_path=bpath, output_path=o,
                              backend=backend, chunk_bytes=BIGRAM_CHUNK,
                              metrics=False, **kw), "bigram")
        m = r.metrics
        log(collect_line(f"bigram {name}", m) + f"; {m['distinct_keys']} "
            f"distinct bigrams, reduce on {m['accumulator_device']}")
        if name == "auto":
            if (type(r.counts._dict).__name__ != "RescanDictionary"
                    or m["accumulator_device"] != "host"):
                raise AssertionError("bigram auto did not take the "
                                     "hash-only collect")
            # the fold's accumulator must hold every distinct bigram
            key_capacity = 1 << (2 * m["distinct_keys"]).bit_length()
            log(f"bigram fold: key_capacity {key_capacity} for "
                f"{m['distinct_keys']} distinct bigrams")
        elif not m["accumulator_device"].startswith(backend):
            raise AssertionError(f"fold on {m['accumulator_device']}")
        if m["data/conservation_violations"] or m[
                "data/conservation_checks"] != 3:
            raise AssertionError(f"bigram {name}: data audit")
        out["bigram"][name] = {"metrics": m, "out": o}
        del r
    if read(out["bigram"]["auto"]["out"]) != read(out["bigram"]["fold"]["out"]):
        raise AssertionError("bigram collect and fold final_result.txt "
                             "differ")
    log("bigram collect and fold final_result.txt byte-identical")

    # the inverted index: the host sort (auto), the card sort (a CUDA-event
    # time for the sort alone) and a forced demotion to disk buckets
    real_sort = collect_mod.sort_pairs
    timing: dict = {}

    def timed_sort(stacked):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_sort(stacked)
        ev[1].record()
        timing.update(events=ev, block=stacked)
        return res

    runs = [("host", {}), ("device", {"collect_sort": "device"}),
            ("demoted", {"shuffle_transport": "hybrid"})]
    ii_path = prefix_file(path, os.path.join(tmp, "ii_corpus.txt"),
                          II_BYTES)
    for name, kw in runs:
        o = os.path.join(tmp, f"postings_{name}.txt")
        if name == "demoted":
            kw["collect_max_rows"] = out["invertedindex"]["host"][
                "metrics"]["pairs"] // 3
        collect_mod.sort_pairs = timed_sort
        try:
            r = run_job(JobConfig(input_path=ii_path, output_path=o,
                                  backend=backend, chunk_bytes=CHUNK_BYTES,
                                  metrics=False, **kw), "invertedindex")
        finally:
            collect_mod.sort_pairs = real_sort
        m = r.metrics
        log(collect_line(f"invertedindex {name}", m) + f"; {m['pairs']} "
            f"pairs, {m['distinct_terms']} terms, grouped_finalize "
            f"{m['grouped_finalize']}")
        if m["data/conservation_violations"]:
            raise AssertionError(f"invertedindex {name}: data audit")
        if (name == "demoted") != ("demote/events" in m):
            raise AssertionError(f"invertedindex {name}: demotion "
                                 f"{m.get('demote/events')}")
        out["invertedindex"][name] = {"metrics": m, "out": o}
        del r
    if "events" not in timing:
        raise AssertionError("the card sort never ran")
    block = timing.pop("block")
    sort_ms = timing["events"][0].elapsed_time(timing["events"][1])
    warm = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        real_sort(block)
        ev[1].record()
        torch.cuda.synchronize()
        warm.append(ev[0].elapsed_time(ev[1]))
    card = {"rows": int(block.shape[1]), "bytes": int(block.nbytes),
            "sort_ms": round(sort_ms, 3),
            "warm_sort_ms": [round(x, 3) for x in warm]}
    del block
    host_m = out["invertedindex"]["host"]["metrics"]
    dev_m = out["invertedindex"]["device"]["metrics"]
    log(f"invertedindex card sort: {card['rows']} padded pairs, "
        f"{card['bytes']} bytes on the card; sort {card['sort_ms']} ms in "
        f"the job (CUDA events), warm {card['warm_sort_ms']} ms; "
        f"sort+postings {dev_m['time/sort+postings_s']:.3f} s (the fetch "
        f"{dev_m['device/compute_ms/max']:.1f} ms) against the host's "
        f"{host_m['time/sort+postings_s']:.3f} s; map+collect "
        f"{dev_m['time/map+collect_s']:.3f} s against "
        f"{host_m['time/map+collect_s']:.3f} s")
    base = read(out["invertedindex"]["host"]["out"])
    for name in ("device", "demoted"):
        if read(out["invertedindex"][name]["out"]) != base:
            raise AssertionError(f"invertedindex {name} postings differ "
                                 "from the host sort's")
    log(f"invertedindex host, card and demoted postings byte-identical "
        f"({len(base)} bytes)")
    ipath = prefix_file(path, os.path.join(tmp, "ii_prefix.txt"),
                        II_MODEL_BYTES)
    prefix_out = os.path.join(tmp, "postings_prefix.txt")
    run_job(JobConfig(input_path=ipath, output_path=prefix_out,
                      backend=backend, chunk_bytes=CHUNK_BYTES // 8,
                      metrics=False), "invertedindex")
    mo = os.path.join(tmp, "postings_model.txt")
    write_postings(mo, inverted_index_model(ipath))
    if read(prefix_out) != read(mo):
        raise AssertionError("invertedindex differs from "
                             "inverted_index_model on the prefix")
    log(f"invertedindex on a {II_MODEL_BYTES >> 20} MB prefix matches "
        "inverted_index_model")

    # distinct: the native map on the whole corpus against the exact count
    # of phase 5; the native and the Python map on a prefix
    exact = wc["runs"]["native"]["metrics"]["distinct_keys"]
    r = run_job(JobConfig(input_path=path, output_path="", backend=backend,
                          chunk_bytes=CHUNK_BYTES, metrics=False),
                "distinct")
    log(f"distinct: estimate {r.estimate:.1f} against phase 5's exact "
        f"{exact} ({r.estimate / exact - 1:+.3%}; rse "
        f"{1.04 / np.sqrt(r.registers.shape[0]):.3%}), "
        f"{r.metrics['registers_filled']} registers filled, job "
        f"{job_s(r.metrics):.2f} s")
    if abs(r.estimate / exact - 1) > 5 * 1.04 / np.sqrt(
            r.registers.shape[0]):
        raise AssertionError("distinct estimate outside 5 rse")
    out["distinct"] = {"estimate": r.estimate, "exact": exact,
                       "metrics": r.metrics}
    dpath = prefix_file(path, os.path.join(tmp, "distinct_prefix.txt"),
                        DISTINCT_PY_BYTES)
    regs = {}
    for mapper in ("native", "python"):
        regs[mapper] = run_job(JobConfig(
            input_path=dpath, output_path="", backend=backend,
            chunk_bytes=CHUNK_BYTES // 32, mapper=mapper, metrics=False),
            "distinct").registers
    if not np.array_equal(regs["native"], regs["python"]):
        raise AssertionError("distinct: native and python registers differ")
    log(f"distinct native and python registers equal on a "
        f"{DISTINCT_PY_BYTES >> 20} MB prefix (exact there "
        f"{distinct_model([read(dpath)])})")

    # resume: the host-sort inverted index of the prefix (4 chunks) killed
    # after II_KILL_AFTER chunks, resumed to the uninterrupted run's bytes
    ck = os.path.join(tmp, "ii_checkpoint")
    o = os.path.join(tmp, "postings_resumed.txt")
    cfg = JobConfig(input_path=ipath, output_path=o, backend=backend,
                    chunk_bytes=CHUNK_BYTES // 8, checkpoint_dir=ck,
                    metrics=False)
    real_pipelined = driver_mod.pipelined

    def dying(it, *a, **k):
        def gen():
            for i, item in enumerate(it):
                if i == II_KILL_AFTER:
                    raise KeyboardInterrupt("simulated kill")
                yield item
        return real_pipelined(gen(), *a, **k)

    driver_mod.pipelined = dying
    try:
        run_job(cfg, "invertedindex")
        raise AssertionError("the killed inverted index ran to its end")
    except KeyboardInterrupt:
        pass
    finally:
        driver_mod.pipelined = real_pipelined
    saved = sorted(n for n in os.listdir(ck) if n.startswith("chunk_"))
    if len(saved) != II_KILL_AFTER:
        raise AssertionError(f"killed inverted index spilled {saved}")
    r = run_job(cfg, "invertedindex")
    m = r.metrics
    if m.get("checkpoint/chunks_replayed") != II_KILL_AFTER:
        raise AssertionError("the resumed inverted index replayed "
                             f"{m.get('checkpoint/chunks_replayed')}")
    if read(o) != read(prefix_out) or os.path.exists(ck):
        raise AssertionError("the resumed inverted index differs from the "
                             "uninterrupted run")
    log(collect_line("invertedindex resumed", m) + "; byte-identical to the "
        f"uninterrupted run of the {II_MODEL_BYTES >> 20} MB prefix, "
        f"{II_KILL_AFTER} chunks replayed")
    launches = {w.__name__: w.launches for w in wrappers}
    if any(launches.values()):
        raise AssertionError(f"phase 9 launched {launches}: no hand kernel "
                             "is on the collect route")
    out["card_sort"] = card
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 9 (collect) wall {out['wall_s']:.1f} s; launches {launches}")
    return out


# --- phase 10 ---------------------------------------------------------------

def save_records(path: str, keys: np.ndarray, payloads: np.ndarray) -> str:
    """(u64 key, u64 payload) records as an ``(n, 2)`` ``.npy``."""
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint64,
                                    shape=(keys.shape[0], 2))
    out[:, 0] = keys
    out[:, 1] = payloads
    out.flush()
    del out
    return path


def dataflow_oracle(workload: str, out: str, paths: list,
                    gap: int = 0) -> str:
    """Writes the NumPy oracle's output of ``workload`` on the record files
    ``paths`` to ``out``, in the job's own format; runs in a worker
    process beside the jobs, so the pure-Python oracles cost no wall."""
    from map_oxidize_tpu_torch.workloads import join, sessionize, sort

    cols = []
    for path in paths:
        rec = np.load(path)
        cols += [rec[:, 0], rec[:, 1]]
    if workload == "sort":
        sort.write_sorted_records(out, [sort.sort_model(*cols)])
    elif workload == "join":
        join.write_join_records(out, *join.join_model(*cols))
    else:
        sessionize.write_sessions(out, *sessionize.sessionize_model(*cols,
                                                                    gap))
    return out


def dataflow_line(name: str, m: dict, sort_ms) -> str:
    """One dataflow job's rows, rate, phases, attribution and card sort."""
    phases = ", ".join(f"{k[5:-2]} {v:.2f} s" for k, v in m.items()
                       if k.startswith("time/") and k.endswith("_s"))
    spill = {k: v for k, v in m.items() if k.startswith(("demote/",
                                                         "spill/"))}
    card = (f"card sort {sort_ms:.3f} ms (CUDA events)"
            if sort_ms is not None else "host sort")
    return (f"{name}: {m['records_in']} rows, job {job_s(m):.2f} s, "
            f"{m['records_in'] / job_s(m):.0f} rows/s over the job; "
            f"{phases}; {card}; {spill or 'no spill'}; {attrib_line(m)}")


def phase_dataflow(tmp: str, backend: str, wrappers) -> dict:
    """Sort, join and sessionize on seeded records (module docstring,
    phase 10), each held to its NumPy oracle, the placements
    byte-identical.  The oracles run in worker processes while the jobs
    run."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    import map_oxidize_tpu_torch.runtime.collect as collect_mod
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads.sort import RESERVED_KEY

    t_phase = time.perf_counter()
    for w in wrappers:
        w.launches = 0
    rng = np.random.default_rng(SEED + 10)
    real_sort = collect_mod.sort_pairs
    sorts: list = []

    def timed_sort(stacked):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_sort(stacked)
        ev[1].record()
        sorts.append((ev, int(stacked.shape[1])))
        return res

    def run(workload, name, **kw):
        o = os.path.join(tmp, f"{workload}_{name}.out")
        sorts.clear()
        collect_mod.sort_pairs = timed_sort
        try:
            r = run_job(JobConfig(output_path=o, backend=backend,
                                  metrics=False, **kw), workload)
        finally:
            collect_mod.sort_pairs = real_sort
        torch.cuda.synchronize()
        sort_ms = (sorts[0][0][0].elapsed_time(sorts[0][0][1])
                   if sorts else None)
        if (kw.get("collect_sort") == "device") != bool(sorts):
            raise AssertionError(f"{workload} {name}: card sorts {sorts}")
        m = r.metrics
        log(dataflow_line(f"{workload} {name}", m, sort_ms)
            + (f"; {sorts[0][1]} padded pairs" if sorts else ""))
        return {"metrics": m, "out": o, "sort_ms": sort_ms}

    # the record files: a sort input with a run of equal keys (the payload
    # order counts), two join sides, one day of session events
    t0 = time.perf_counter()
    keys = rng.integers(0, 1 << 64, SORT_N, dtype=np.uint64)
    keys[keys == RESERVED_KEY] -= np.uint64(1)
    keys[:1 << 16] = keys[0]
    recs = {"sort": save_records(
        os.path.join(tmp, "sort.npy"), keys,
        rng.integers(0, 1 << 64, SORT_N, dtype=np.uint64))}
    del keys
    for side in ("a", "b"):
        recs[side] = save_records(
            os.path.join(tmp, f"{side}.npy"),
            rng.integers(0, JOIN_KEYS, JOIN_N, dtype=np.uint64),
            rng.integers(0, 1 << 63, JOIN_N, dtype=np.uint64))
    recs["events"] = save_records(
        os.path.join(tmp, "events.npy"),
        rng.integers(0, SESS_KEYS, SESS_N, dtype=np.uint64),
        rng.integers(0, SESS_SPAN, SESS_N, dtype=np.uint64))
    log(f"records: sort {SORT_N}, join 2 x {JOIN_N}, sessionize {SESS_N} "
        f"rows ({time.perf_counter() - t0:.1f} s to make)")
    models = {w: os.path.join(tmp, f"{w}_model.out")
              for w in ("sort", "join", "sessionize")}
    out: dict = {"sort": {}, "join": {}, "sessionize": {}}
    with ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        oracles = {
            "sort": pool.submit(dataflow_oracle, "sort", models["sort"],
                                [recs["sort"]]),
            "join": pool.submit(dataflow_oracle, "join", models["join"],
                                [recs["a"], recs["b"]]),
            "sessionize": pool.submit(
                dataflow_oracle, "sessionize", models["sessionize"],
                [recs["events"]], SESS_GAP)}
        # sort: host, card and a forced demotion
        for name, kw in (("host", {}),
                         ("device", {"collect_sort": "device"}),
                         ("demoted", {"collect_max_rows": SORT_N // 3,
                                      "shuffle_transport": "hybrid"})):
            out["sort"][name] = run("sort", name, input_path=recs["sort"],
                                    chunk_bytes=CHUNK_BYTES, **kw)
        if "demote/events" not in out["sort"]["demoted"]["metrics"]:
            raise AssertionError("the forced sort demotion did not demote")
        # join: both sorts
        for name, kw in (("host", {}),
                         ("device", {"collect_sort": "device"})):
            out["join"][name] = run("join", name, input_path=recs["a"],
                                    join_input_path=recs["b"],
                                    chunk_bytes=CHUNK_BYTES, **kw)
        # sessionize: the card sort
        out["sessionize"]["device"] = run(
            "sessionize", "device", input_path=recs["events"],
            chunk_bytes=CHUNK_BYTES, session_gap=SESS_GAP,
            collect_sort="device")
        t0 = time.perf_counter()
        for w in models:
            oracles[w].result()
    log(f"oracles done {time.perf_counter() - t0:.1f} s after the last job")
    for w, runs in out.items():
        want = read(models[w])
        for name, run_out in runs.items():
            if read(run_out["out"]) != want:
                raise AssertionError(f"{w} {name} differs from its oracle")
    log(f"sort host, card and demoted, join host and card "
        f"({out['join']['host']['metrics']['join/matches']} matches) and "
        f"sessionize on the card "
        f"({out['sessionize']['device']['metrics']['sessions/count']} "
        "sessions) byte-identical to sort_model, join_model and "
        "sessionize_model")
    launches = {w.__name__: w.launches for w in wrappers}
    if any(launches.values()):
        raise AssertionError(f"phase 10 launched {launches}: no hand kernel "
                             "is on the dataflow route")
    out["launches"] = launches
    out["inputs"] = recs
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 10 (dataflow) wall {out['wall_s']:.1f} s; launches "
        f"{launches}")
    return out


# --- phase 11 ---------------------------------------------------------------

def profile_device_map(path: str, backend: str) -> dict:
    """A device-map word count over a ``DEVMAP_PROFILE_CHUNKS``-chunk prefix
    under ``torch.profiler``: the device's busy share of the host window,
    the kernel's and the copies' shares, and the host-to-device GB/s of
    the chunk copies while they copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run_job(JobConfig(input_path=path, output_path="",
                              backend=backend, mapper="device",
                              chunk_bytes=CHUNK_BYTES, metrics=False),
                    "wordcount")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev, busy, copy = device_intervals(prof)
    if not ev:
        return {"note": "the profiler recorded no device events: not "
                        "measured"}
    kernel = sum(b - a for a, b, name in ev if "tokenize_compact" in name)
    chunks = r.metrics["chunks"]
    big = sorted((b - a for a, b, name in ev if "Memcpy HtoD" in name),
                 reverse=True)[:chunks]
    ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    ops.sort(key=lambda kv: -kv[1])
    return {"chunks": chunks, "wall_ms": wall_us / 1e3,
            "busy_share": busy / wall_us, "kernel_share": kernel / wall_us,
            "copy_share": copy / wall_us,
            "h2d_gb_s": chunks * CHUNK_BYTES / (sum(big) * 1e-6) / 1e9,
            "top": [(name[:48], round(t / 1e3, 3)) for name, t in ops[:6]]}


def phase_device_map(tmp: str, backend: str, wc: dict, collect: dict,
                     wrappers) -> dict:
    """The device mapper (module docstring, phase 11): word count on phase
    5's corpus, bigram on phase 9's prefix, a killed and resumed word
    count."""
    import map_oxidize_tpu_torch.runtime.device_map as dm
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact
    from map_oxidize_tpu_torch.runtime import run_job

    t_phase = time.perf_counter()
    path = wc["path"]
    native = wc["runs"]["native"]
    out: dict = {}

    # the counted run: word count on phase 5's corpus
    o = os.path.join(tmp, "final_result_device.txt")
    for w in wrappers:
        w.launches = 0
    r = run_job(JobConfig(input_path=path, output_path=o, backend=backend,
                          mapper="device", chunk_bytes=CHUNK_BYTES,
                          metrics=False), "wordcount")
    launches = {w.__name__: w.launches for w in wrappers}
    m = r.metrics
    log(collect_line("wordcount mapper=device", m)
        + f"; {m['distinct_keys']} distinct, {m['chunks']} chunks, "
        f"records_per_sec {m['records_per_sec']}, accumulator on "
        f"{m['accumulator_device']}; launches {launches}")
    if launches["tokenize_compact"] != m["chunks"]:
        raise AssertionError(f"tokenize_compact launched "
                             f"{launches['tokenize_compact']} times for "
                             f"{m['chunks']} chunks")
    if launches["fused_assign_sum"]:
        raise AssertionError("the device map launched the k-means kernel")
    if read(o) != read(native["out"]):
        raise AssertionError("device-map final_result.txt differs from "
                             "phase 5's native run")
    nm = native["metrics"]
    log(f"device-map word count byte-identical to phase 5's native run: "
        f"{m['records_in'] / job_s(m):.0f} words/s over the job against "
        f"native {nm['records_in'] / job_s(nm):.0f} (map+reduce "
        f"{m['time/map+reduce_s']:.2f} s against "
        f"{nm['time/map+reduce_s']:.2f} s)")
    out["wordcount"] = {"metrics": m, "launches": launches}
    prof_path = prefix_file(path, os.path.join(tmp, "devmap_prefix.txt"),
                            DEVMAP_PROFILE_CHUNKS * CHUNK_BYTES)
    out["profile"] = profile_device_map(prof_path, backend)
    log(f"device-map profile over a {DEVMAP_PROFILE_CHUNKS}-chunk prefix: "
        f"{out['profile']}")

    # bigram on phase 9's prefix as one chunk, against the native bigram
    # at the same chunking (bigram pairs never straddle chunks, and the
    # device mapper cuts chunks at any whitespace, the host at newlines)
    bpath = os.path.join(tmp, "bigram_corpus.txt")
    distinct = collect["bigram"]["auto"]["metrics"]["distinct_keys"]
    chunk_keys = 1 << distinct.bit_length()
    runs = {}
    for name, kw in (("device", {"mapper": "device",
                                 "device_chunk_keys": chunk_keys}),
                     ("native", {})):
        ob = os.path.join(tmp, f"bigram_one_chunk_{name}.txt")
        for w in wrappers:
            w.launches = 0
        rb = run_job(JobConfig(input_path=bpath, output_path=ob,
                               backend=backend, chunk_bytes=BIGRAM_BYTES,
                               key_capacity=chunk_keys, metrics=False, **kw),
                     "bigram")
        runs[name] = {"metrics": rb.metrics, "out": ob,
                      "launches": {w.__name__: w.launches
                                   for w in wrappers}}
        log(collect_line(f"bigram {name} (one chunk)", rb.metrics)
            + f"; launches {runs[name]['launches']}")
    if read(runs["device"]["out"]) != read(runs["native"]["out"]):
        raise AssertionError("device-map bigram differs from the native "
                             "bigram at the same chunking")
    log(f"device-map bigram byte-identical to the native bigram "
        f"({runs['device']['metrics']['distinct_keys']} distinct bigrams; "
        f"device_chunk_keys {chunk_keys} from phase 9's {distinct})")
    out["bigram"] = runs

    # killed past its first snapshot, resumed
    ck = os.path.join(tmp, "devmap_checkpoint")
    o = os.path.join(tmp, "final_result_device_resumed.txt")
    cfg = JobConfig(input_path=path, output_path=o, backend=backend,
                    mapper="device", chunk_bytes=DEVMAP_SNAP_CHUNK,
                    checkpoint_dir=ck, metrics=False)
    real = dm.iter_chunks_into

    def dying(*a, **k):
        for i, c in enumerate(real(*a, **k)):
            if i == DEVMAP_KILL_AFTER:
                raise KeyboardInterrupt("simulated kill")
            yield c

    dm.iter_chunks_into = dying
    t0 = time.perf_counter()
    try:
        run_job(cfg, "wordcount")
        raise AssertionError("the killed device map ran to its end")
    except KeyboardInterrupt:
        pass
    finally:
        dm.iter_chunks_into = real
    t_killed = time.perf_counter() - t0
    if not os.path.isfile(os.path.join(ck, "snapshot.npz")):
        raise AssertionError("the killed device map left no snapshot")
    r = run_job(cfg, "wordcount")
    m = r.metrics
    if read(o) != read(native["out"]) or os.path.exists(ck):
        raise AssertionError("the resumed device map differs from phase "
                             "5's output")
    log(f"device-map word count in {DEVMAP_SNAP_CHUNK >> 20} MiB chunks "
        f"killed after {DEVMAP_KILL_AFTER} chunks ({t_killed:.2f} s), "
        f"resumed from the snapshot at chunk {dm._SNAP_EVERY}: "
        f"byte-identical to phase 5 ({m['chunks']} chunks, job "
        f"{job_s(m):.2f} s)")
    out["resume"] = {"metrics": m, "killed_s": t_killed}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 11 (device map) wall {out['wall_s']:.1f} s")
    return out


# --- phase 12 ---------------------------------------------------------------

#: iterations of each phase-12 fit: phase 7's, so its counted B=1 fits
#: are the pinned reference
PLAN_ITERS = STREAM_ITERS
PEAK_MM = 8192        # the bf16 matmul probe's square size


def measure_peaks() -> dict:
    """The card's sustained bf16 matmul rate (``torch.matmul`` at
    ``PEAK_MM``^3, FLOPs = 2 m n k over the CUDA-event time) and its
    device-to-device copy rate (a 1 GiB ``copy_``, bytes read plus bytes
    written over the time), beside the published peaks ``obs/xprof.py``
    quotes MFU against.  A probe, not a port of anything."""
    import torch

    a = torch.randn(PEAK_MM, PEAK_MM, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(PEAK_MM, PEAK_MM, device="cuda", dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), reps=20, warmup=3)
    del a, b
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = time_ms(lambda: dst.copy_(src), reps=20, warmup=3)
    del src, dst
    torch.cuda.empty_cache()
    return {"flops": 2.0 * PEAK_MM ** 3 / (mm_ms / 1e3),
            "membw": 2.0 * (1 << 30) / (cp_ms / 1e3),
            "matmul_ms": mm_ms, "copy_ms": cp_ms}


def xprof_line(name: str, row: dict, peaks: dict) -> str:
    """One observed program's ``xprof`` row: dispatches, sampled device
    ms, achieved rates, MFU against the measured peak, and the bound."""
    fl = row.get("achieved_flops_per_s")
    by = row.get("achieved_bytes_per_s")
    fl_s = "-" if fl is None else f"{fl:.6g}"
    by_s = "-" if by is None else f"{by:.6g}"
    mfu = "-" if fl is None else f"{100 * fl / peaks['flops']:.3f}"
    bw = "-" if by is None else f"{100 * by / peaks['membw']:.3f}"
    return (f"{name}: {row['dispatches']} dispatches ({row['compiles']} "
            f"compiles, {row['logical_chunks']} logical chunks), sampled "
            f"device {row['sampled_device_ms']:.3f} ms over "
            f"{row['device_samples']} samples, device time "
            f"{row.get('device_s_est')} s ({row.get('device_time_source')})"
            f", achieved {fl_s} FLOP/s ({mfu}% of the measured bf16 matmul "
            f"peak; mfu_pct {row.get('mfu_pct')}), {by_s} B/s ({bw}% of "
            f"the measured copy rate), bound {row.get('bound')}")


def phase_plan(tmp: str, backend: str, stream: dict, km: dict,
               km_resume: dict, wrappers) -> dict:
    """Phase 12: the dispatch-batch resolver and the job planner on phase
    7's file (see the module docstring)."""
    import torch

    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.obs.compile import LEDGER
    from map_oxidize_tpu_torch.runtime import dispatch, run_job

    card = card_line()
    peaks = measure_peaks()
    log(f"peaks on {card}: bf16 matmul {PEAK_MM}^3 {peaks['matmul_ms']:.4f}"
        f" ms = {peaks['flops']:.6g} FLOP/s; 1 GiB device copy "
        f"{peaks['copy_ms']:.4f} ms = {peaks['membw']:.6g} B/s (read + "
        f"written)")
    path, n_chunks = stream["path"], stream["n_chunks"]
    out = {"peaks": peaks, "runs": {}}

    def fit(precision, name, **kw):
        doc = os.path.join(tmp, f"plan_{precision}_{name}.json")
        r = run_job(JobConfig(input_path=path, output_path="",
                              backend=backend, kmeans_k=STREAM_K,
                              kmeans_iters=PLAN_ITERS,
                              kmeans_precision=precision, metrics=False,
                              metrics_out=doc, **kw), "kmeans")
        if r.metrics["kmeans_mode"] != "stream_device":
            raise AssertionError(f"phase 12 ran {r.metrics['kmeans_mode']}")
        if not np.isfinite(r.centroids).all():
            raise AssertionError(f"phase 12 {precision} {name}: non-finite")
        with open(doc) as f:
            return r, json.load(f)

    def fresh_process():
        # a fresh process's resolver: no launch history, no memo
        LEDGER.reset()
        dispatch._auto_cache.clear()

    for w in wrappers:
        w.launches = 0
    for precision in ("highest", "bf16"):
        calib_dir = os.path.join(tmp, f"calib_{precision}")
        runs = {}
        for name in ("cold", "warm"):
            fresh_process()
            runs[name] = fit(precision, name, dispatch_batch=0, plan="auto",
                             calib_dir=calib_dir)
        # the pinned B=1 reference: phase 7's counted fit of this file
        ref = stream["runs"][precision]["centroids"]
        row = {}
        sched = stream["runs"][precision]["schedules"]
        for name in ("cold", "warm"):
            r, doc = runs[name]
            m = r.metrics
            if r.centroids.tobytes() != ref.tobytes():
                raise AssertionError(f"phase 12 {precision} {name}: auto B "
                                     f"{m['dispatch/batch']} differs from "
                                     "a pinned B=1")
            ms = m["time/feed_s"] / PLAN_ITERS * 1e3
            rec = {k[len("dispatch/"):]: v for k, v in m.items()
                   if k.startswith("dispatch/")}
            plan = doc.get("plan") or {}
            row[name] = {"ms_per_iter": ms, "dispatch": rec,
                         "plan_provenance": plan.get("provenance"),
                         "predicted_wall_ms": (plan.get("predicted")
                                               or {}).get("wall_ms"),
                         "actual_wall_ms": (plan.get("actual")
                                            or {}).get("wall_ms"),
                         "model_error_pct": plan.get("model_error_pct"),
                         "xprof": doc["xprof"]["programs"].get(
                             "kmeans/stream_step")}
            log(f"phase 12 {precision} {name} (dispatch_batch=0, "
                f"calib_dir {'empty' if name == 'cold' else 'warm'}): B "
                f"{rec.get('batch')}, rule {rec.get('rule')}, floor "
                f"{rec.get('floor_ms')} ms ({rec.get('floor_source')}), "
                f"compute {rec.get('compute_ms_per_chunk')} ms "
                f"({rec.get('compute_source')}), produce "
                f"{rec.get('produce_ms_per_chunk')} ms, hbm_cap "
                f"{rec.get('hbm_cap')}; {ms:.3f} ms/iter beside phase 7's "
                f"B=1 {', '.join(f'{t:.3f}' for t in sched['depth 2, B 1'])}"
                f" and B=8 "
                f"{', '.join(f'{t:.3f}' for t in sched['depth 2, B 8'])} "
                f"ms/iter; plan provenance {row[name]['plan_provenance']}, "
                f"predicted wall {row[name]['predicted_wall_ms']} ms, "
                f"actual {row[name]['actual_wall_ms']} ms, "
                f"plan/model_error_pct {m.get('plan/model_error_pct')}; "
                f"{card}")
            log(f"phase 12 {precision} {name} " + xprof_line(
                "kmeans/stream_step", row[name]["xprof"], peaks))
        if row["warm"]["plan_provenance"] != "curve":
            raise AssertionError(f"phase 12 {precision}: the warm plan is "
                                 f"{row['warm']['plan_provenance']}")
        if row["cold"]["dispatch"].get("batch_mode") != "auto":
            raise AssertionError(f"phase 12 {precision}: not auto")
        row["pinned_ms_per_iter"] = stream["runs"][precision]["ms_per_iter"]
        log(f"phase 12 {precision}: cold and warm auto-B centroids "
            f"bit-equal to phase 7's pinned B=1 fit "
            f"({row['pinned_ms_per_iter']:.3f} ms/iter)")
        for src, name, doc in (("phase 4", "kmeans/fit",
                                km["xprof"][precision]),
                               ("phase 6", "kmeans/step",
                                km_resume["xprof"][precision])):
            prog = doc["programs"].get(name)
            if prog is None:
                raise AssertionError(f"{src} observed no {name}")
            row[name] = prog
            log(f"phase 12 {precision}: {src}'s " + xprof_line(
                name, prog, peaks) + f"; {card}")
        out["runs"][precision] = row
    launches = {w.__name__: w.launches for w in wrappers}
    want = 2 * 2 * PLAN_ITERS * n_chunks
    log(f"phase 12 launches: {launches} (2 precisions x 2 fits x "
        f"{PLAN_ITERS} iterations x {n_chunks} chunks = {want})")
    if launches["fused_assign_sum"] != want:
        raise AssertionError(f"phase 12 launched {launches}, expected {want}")
    out["launches"] = launches
    torch.cuda.empty_cache()
    return out


# --- phase 13 ---------------------------------------------------------------

#: phase 13's k-means job under the capture: bf16 iterations enough for a
#: fit that outlasts the profiler's start (~9 s, the first in a process)
#: and the capture window; a served job's heartbeat fetches the centroids
#: every iteration (~5 ms each)
SERVE_CAPTURE_ITERS = 6000
SERVE_CAPTURE_S = 2.0
#: the endpoints' key sets (the JAX package's documents)
SERVE_KEYS = {
    "/healthz": {"schema", "version", "t_unix_s", "uptime_s", "phase",
                 "workload", "process", "n_processes", "jobs"},
    "/status": {"schema", "meta", "t_unix_s", "elapsed_s", "phase",
                "progress", "xprof", "hbm", "counters", "comms"},
    "/series": {"schema", "interval_s", "capacity", "samples_taken",
                "t_unix_s", "series"},
    "/alerts": {"schema", "t_unix_s", "interval_s", "counts", "firing",
                "resolved", "rules", "timeline"},
    "/jobs": {"schema", "t_unix_s", "uptime_s", "draining", "workers",
              "queue", "hbm", "corpora", "counts", "jobs"},
}


def prom_values(text: str) -> dict:
    """``{series: value}`` of a Prometheus text document's samples."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, v = line.rpartition(" ")
            out[name] = float(v)
    return out


def serve_job_line(name: str, row: dict, m: dict) -> str:
    return (f"{name}: {row['state']}, submit-to-done "
            f"{row['finished_unix_s'] - row['submitted_unix_s']:.3f} s, "
            f"queue wait {row['queue_wait_s']:.3f} s, run wall "
            f"{row['duration_s']:.3f} s, job {job_s(m):.3f} s, compiles "
            f"{m.get('compile/total_compiles')}")


def phase_serve(tmp: str, km: dict, wc: dict, devmap: dict) -> dict:
    """The resident job service (module docstring, phase 13): ``python -m
    map_oxidize_tpu_torch serve`` as a subprocess, driven over HTTP; the
    subprocess is killed if a check fails."""
    t_phase = time.perf_counter()
    spool = os.path.join(tmp, "serve_spool")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    log_path = os.path.join(tmp, "serve.log")
    with open(log_path, "w") as srv_log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "map_oxidize_tpu_torch", "serve",
             "--port", "0", "--workers", "2", "--spool-dir", spool,
             "--obs-sample-interval", "0.25"],
            cwd=tmp, env=env, stdout=srv_log, stderr=subprocess.STDOUT)
    try:
        out = _drive_server(tmp, spool, proc, km, wc, devmap)
    except BaseException:
        proc.kill()
        proc.wait(timeout=60)
        with open(log_path) as f:
            log("server log tail:\n" + f.read()[-4000:])
        raise
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 13 (serve) wall {out['wall_s']:.1f} s")
    return out


def _drive_server(tmp: str, spool: str, proc, km: dict, wc: dict,
                  devmap: dict) -> dict:
    import threading
    import urllib.request

    import torch

    from map_oxidize_tpu_torch.serve.client import ServeClient

    port_file = os.path.join(spool, "obs_port.json")
    t0 = time.perf_counter()
    while not os.path.isfile(port_file):
        if proc.poll() is not None:
            raise AssertionError(f"the server exited {proc.returncode}")
        if time.perf_counter() - t0 > 120:
            raise AssertionError("the server wrote no obs_port.json")
        time.sleep(0.05)
    with open(port_file) as f:
        url = json.load(f)["url"]
    c = ServeClient(url, timeout_s=60)
    # the warm-up on the card publishes the admission budget
    budget = None
    while budget is None:
        budget = c.status()["hbm"].get("hbm/budget_bytes")
        if budget is None:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("the server never published "
                                     "hbm/budget_bytes")
            time.sleep(0.05)
    total = torch.cuda.get_device_properties(0).total_memory
    if budget != total:
        raise AssertionError(f"hbm/budget_bytes {budget} != the card's "
                             f"{total}")
    log(f"server up at {url} in {time.perf_counter() - t0:.2f} s, "
        f"hbm/budget_bytes {budget} (the card's total memory)")
    out: dict = {"rows": {}}

    def run(name, workload, path, config, output, watch=False):
        t = time.perf_counter()
        row = c.submit(workload, path, config=config, output=output)
        live = 0
        while row["state"] in ("queued", "running"):
            if watch and row["state"] == "running":
                live = max(live, c.status()["hbm"].get(
                    "hbm/live_bytes_device0", 0))
            time.sleep(0.05)
            row = c.job(row["id"])
        wall = time.perf_counter() - t
        if row["state"] != "done":
            raise AssertionError(f"{name}: {row['state']} "
                                 f"({row.get('reason')})")
        m = row["metrics"]
        out["rows"][name] = {"row": row, "client_s": wall}
        log(serve_job_line(name, row, m) + f", client wall {wall:.3f} s")
        return row, m, live

    # a cold and a warm k-means job on phase 4's file
    km_cfg = {"kmeans_k": KMEANS_K, "kmeans_iters": KMEANS_ITERS,
              "kmeans_precision": "highest"}
    for i, name in enumerate(("kmeans cold", "kmeans warm")):
        o = os.path.join(tmp, f"serve_centroids_{i}.npy")
        row, m, live = run(name, "kmeans", km["path"], km_cfg, o,
                           watch=(i == 0))
        got = np.load(o)
        if not np.array_equal(got, km["centroids"]["highest"]):
            raise AssertionError(f"{name}: centroids differ from phase "
                                 f"4's run_job (max |d| "
                                 f"{np.abs(got - km['centroids']['highest']).max()})")
        if i == 0:
            if not live > 0:
                raise AssertionError("hbm/live_bytes_device0 was 0 while "
                                     "the cold job ran")
            out["live_bytes"] = live
            log(f"hbm/live_bytes_device0 {live} while the cold job ran")
    if row["compiles"] != 0 or m["compile/total_compiles"] != 0:
        raise AssertionError(f"the warm k-means job compiled "
                             f"{m['compile/total_compiles']} programs")
    prom = prom_values(urllib.request.urlopen(url + "/metrics",
                                              timeout=60).read().decode())
    if prom.get("moxt_serve_warm_compiles", 0) != 0:
        raise AssertionError("serve/warm_compiles moved on the warm job")
    firing = [a["rule"] for a in c._request("/alerts")["firing"]]
    if "warm-serve-recompile" in firing:
        raise AssertionError("warm-serve-recompile fired")
    log("the warm k-means job: 0 compiles, bit-equal to phase 4's "
        "run_job; serve/warm_compiles 0; no warm-serve-recompile alert")

    # two word counts at once: the native host map and the device map
    native = wc["runs"]["native"]
    outs = {n: os.path.join(tmp, f"serve_final_result_{n}.txt")
            for n in ("auto", "device")}
    subs = {n: c.submit("wordcount", wc["path"],
                        config={"mapper": n, "chunk_bytes": CHUNK_BYTES},
                        output=outs[n])
            for n in ("auto", "device")}
    rows = {n: c.wait(r["id"], timeout_s=600) for n, r in subs.items()}
    docs = {}
    for n, row in rows.items():
        if row["state"] != "done":
            raise AssertionError(f"wordcount {n}: {row['state']} "
                                 f"({row.get('reason')})")
        row = rows[n] = c.job(row["id"])
        if read(outs[n]) != read(native["out"]):
            raise AssertionError(f"served wordcount mapper={n} differs "
                                 f"from phase 5's final_result.txt")
        with open(row["artifacts"]["metrics_out"]) as f:
            docs[n] = json.load(f)
        out["rows"][f"wordcount {n}"] = {"row": row}
    dev = rows["device"]["metrics"]
    tok = docs["device"]["xprof"]["programs"]["device_map/tokenize"]
    if tok["dispatches"] != dev["chunks"]:
        raise AssertionError(f"device_map/tokenize dispatched "
                             f"{tok['dispatches']} times for "
                             f"{dev['chunks']} chunks")
    solo = {"auto": native["metrics"],
            "device": devmap["wordcount"]["metrics"]}
    rates = {}
    for n, row in rows.items():
        m = row["metrics"]
        rates[n] = m["records_in"] / job_s(m)
        s = solo[n]
        log(serve_job_line(f"wordcount {n} (concurrent)", row, m)
            + f"; {rates[n]:.0f} words/s against "
            f"{s['records_in'] / job_s(s):.0f} alone (phase "
            f"{5 if n == 'auto' else 11}); device/compute_ms count "
            f"{m.get('device/compute_ms/count')} p50 "
            f"{m.get('device/compute_ms/p50')} max "
            f"{m.get('device/compute_ms/max')} against alone "
            f"{s.get('device/compute_ms/count')} / "
            f"{s.get('device/compute_ms/p50')} / "
            f"{s.get('device/compute_ms/max')}")
    log(f"both served word counts byte-identical to phase 5's; the device "
        f"job's device_map/tokenize {tok['dispatches']} dispatches = "
        f"{dev['chunks']} chunks, its compile_ms {tok['compile_ms']}, "
        f"backend_compile_ms {tok['backend_compile_ms']} (the library was "
        f"built in phase 2, so the server only loads it)")
    out["rates"] = rates

    # a capture during a bf16 k-means job: the job first, the capture once
    # its fit runs, and the fit must outlast the capture's window
    o = os.path.join(tmp, "serve_centroids_bf16.npy")
    row = c.submit("kmeans", km["path"], output=o, config=dict(
        km_cfg, kmeans_precision="bf16", kmeans_iters=SERVE_CAPTURE_ITERS))
    while row["state"] in ("queued", "running") and row.get(
            "phase") != "iterate":
        time.sleep(0.02)
        row = c.job(row["id"])
    if row["state"] != "running":
        raise AssertionError(f"the bf16 job ended before its fit was seen "
                             f"({row['state']}, {row.get('reason')})")
    t_post = time.perf_counter()
    doc = c._request("/profile", {"duration_s": SERVE_CAPTURE_S,
                                  "label": "phase 13"})
    post_s = time.perf_counter() - t_post
    row = c.wait(row["id"], timeout_s=600)
    if row["state"] != "done":
        raise AssertionError(f"the captured bf16 job: {row['state']} "
                             f"({row.get('reason')})")
    row = c.job(row["id"])
    out["rows"]["kmeans bf16 (captured)"] = {"row": row}
    log(serve_job_line("kmeans bf16 (captured)", row, row["metrics"]))
    window_end = doc["t_unix_s"] + doc["duration_s"]
    if row["finished_unix_s"] < window_end:
        raise AssertionError(
            f"the bf16 job ended {window_end - row['finished_unix_s']:.3f}"
            " s before the capture's window did")
    got = np.load(o)
    if got.shape != (KMEANS_K, KMEANS_D) or not np.isfinite(got).all():
        raise AssertionError("the captured bf16 job's centroids are bad")
    dev_doc = doc["device"]
    if "error" in dev_doc or "skipped" in dev_doc or "trace" not in dev_doc:
        raise AssertionError(f"the capture's device half: {dev_doc}")
    with open(dev_doc["trace"]) as f:
        events = json.load(f).get("traceEvents", [])
    hits = dict(collections.Counter(
        e.get("cat", "-") for e in events
        if "kmeans_assign_sum" in e.get("name", "")))
    if not hits:
        cats = collections.Counter(e.get("cat", "-") for e in events)
        raise AssertionError(f"the capture names no kmeans_assign_sum "
                             f"({len(events)} events by category "
                             f"{dict(cats)})")
    log(f"POST /profile {SERVE_CAPTURE_S:g} s during the bf16 job (the "
        f"request took {post_s:.3f} s): "
        f"{doc['host_samples']} host samples, running jobs "
        f"{doc.get('meta', {}).get('running_jobs')}, events naming "
        f"kmeans_assign_sum by category {hits}")
    out["capture"] = {"kernels": hits, "host_samples": doc["host_samples"],
                      "bundle": os.path.dirname(dev_doc["dir"])}

    # a rejection past the card's memory
    rej = c.submit("wordcount", wc["path"], config={"key_capacity": 1 << 33})
    if (rej["state"] != "rejected" or not str(rej["reason"]).startswith(
            "working_set_exceeds_hbm_budget")):
        raise AssertionError(f"the oversized job: {rej['state']} "
                             f"({rej['reason']})")
    log(f"oversized submission rejected: {rej['reason']}")

    # phase 14's fleet step, while this server is up
    out["fleet"] = drive_fleet(tmp, "cuda", spool, url, c, km)

    # the endpoints
    for path, keys in SERVE_KEYS.items():
        got_keys = set(c._request(path))
        if got_keys != keys:
            raise AssertionError(f"{path} keys {sorted(got_keys)} != "
                                 f"{sorted(keys)}")
    text = urllib.request.urlopen(url + "/metrics",
                                  timeout=60).read().decode()
    prom = prom_values(text)
    for needle in ("# TYPE moxt_serve_queue_wait_ms summary",
                   "# TYPE moxt_serve_queue_wait_ms_hist histogram",
                   "# TYPE moxt_hbm_budget_bytes gauge"):
        if needle not in text:
            raise AssertionError(f"/metrics lacks {needle!r}")
    launches = {n: int(prom.get(f"moxt_kernels_{n}_launches", 0))
                for n in ("kmeans_assign_sum", "tokenize_compact")}
    want = {"kmeans_assign_sum": 2 * KMEANS_ITERS + SERVE_CAPTURE_ITERS
            + FLEET_KM_ITERS, "tokenize_compact": dev["chunks"]}
    if launches != want:
        raise AssertionError(f"the server's kernel launches {launches} != "
                             f"{want}")
    out["launches"] = launches
    hist = {k: prom.get(f"moxt_serve_{k}_sum") for k in
            ("queue_wait_ms", "admission_wait_ms", "run_wall_ms")}
    log(f"endpoints hold the JAX key sets; the server's kernel launches "
        f"{launches}; latency sums over {int(prom['moxt_serve_jobs_done'])}"
        f" done jobs (ms) {hist}")

    # shutdown: a clean drain
    c.shutdown(drain=True)
    rc = proc.wait(timeout=180)
    if rc != 0:
        raise AssertionError(f"the server exited {rc} after the drain")
    if os.path.exists(port_file):
        raise AssertionError("obs_port.json outlived the server")
    with open(os.path.join(spool, "ledger", "ledger.jsonl")) as f:
        entries = [json.loads(line) for line in f if line.strip()]
    done = int(prom["moxt_serve_jobs_done"])
    if len(entries) != done or done != 6:
        raise AssertionError(f"{len(entries)} ledger entries for {done} "
                             f"done jobs")
    log(f"POST /shutdown drained the server: exit 0, obs_port.json gone, "
        f"{len(entries)} ledger entries for {done} done jobs")
    return out


# --- phase 14 ---------------------------------------------------------------

#: phase 14's card jobs: resident k-means fits at phase 4's shape into one
#: ledger and calibration store, device-map word counts into a second
OBS_KM_RUNS = 3
OBS_WC_RUNS = 2
#: the served k-means the fleet collector watches (bf16, ~3 ms a served
#: iteration) and the collector's sweeps, 0.25 s apart
FLEET_KM_ITERS = 2000
FLEET_SWEEPS = 32
#: the one-shot card job with its live plane the collector also watches:
#: phase 4's fit with enough iterations to outlast the sweeps (a live
#: plane's heartbeat fetches the centroids every iteration)
FLEET_JOB_ITERS = 1500
#: a card job: the port's CLI ``main`` (what ``python -m
#: map_oxidize_tpu_torch`` runs) in a fresh process, which then prints the
#: hand kernels' launch counts of that process as its last line
CARD_JOB = ("import json, sys\n"
            "from map_oxidize_tpu_torch.cli import main\n"
            "from map_oxidize_tpu_torch.ops import kernel_launches\n"
            "rc = main(sys.argv[1:])\n"
            "print(json.dumps(kernel_launches()), flush=True)\n"
            "sys.exit(rc)\n")


def port_env(**extra) -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=root, **extra)


def card_job(name: str, argv: list, env: dict) -> dict:
    """One card job through the CLI in its own process: its launch counts
    (from 0, the process's own)."""
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", CARD_JOB, *argv], env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"card job {name}: exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    launches = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"card job {name}: exit 0 in {wall:.2f} s (process start "
        f"included), launches {launches}")
    return launches


def obs_cli(walls: list, argv: list, rc: int = 0, env=None) -> str:
    """``python -m map_oxidize_tpu_torch obs <argv>`` as a user runs it:
    its exit code must be ``rc``; its wall is logged and kept."""
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "map_oxidize_tpu_torch", "obs", *argv],
        env=env or port_env(), capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    label = " ".join(os.path.basename(a) if os.sep in a else a
                     for a in argv)
    walls.append((label, wall))
    log(f"obs {label}: exit {res.returncode} in {wall:.3f} s, "
        f"{len(res.stdout.splitlines())} lines")
    if res.returncode != rc:
        raise AssertionError(f"obs {label}: exit {res.returncode}, "
                             f"expected {rc}\n{res.stderr[-3000:]}")
    return res.stdout


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def drive_fleet(tmp: str, backend: str, spool: str, url: str, c,
                km: dict) -> dict:
    """Phase 14's fleet half, a step of phase 13 before its drain: a
    served bf16 k-means and a one-shot k-means card job with its live
    plane run while ``obs fleet`` watches both (the server through its
    spool, the job through ``MOXT_OBS_PORT_FILE``), archiving.  The
    collector's ``/metrics`` carries both as labelled targets, the
    server's with its device-memory gauges, and the server it found
    publishes the kernel's launches; ``obs top`` renders the per-target
    table; after the collector exits ``obs top/where/trend/critpath
    --archive`` read the archive."""
    import urllib.request

    t0 = time.perf_counter()
    walls: list = []
    arch = os.path.join(tmp, "fleet_archive")
    ports = os.path.join(tmp, "fleet_ports.txt")
    label = url[len("http://"):]
    o = os.path.join(tmp, "fleet_centroids.npy")
    job_out = os.path.join(tmp, "fleet_job_centroids.npy")
    job = subprocess.Popen(
        [sys.executable, "-c", CARD_JOB, "kmeans", km["path"], "--backend",
         backend, "--kmeans-k", str(KMEANS_K), "--kmeans-iters",
         str(FLEET_JOB_ITERS), "--kmeans-precision", "highest",
         "--obs-port", "0", "--obs-spool", "none", "--output", job_out,
         "-q"], env=port_env(MOXT_OBS_PORT_FILE=ports),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc = None
    try:
        deadline = time.perf_counter() + 120
        while not (os.path.exists(ports) and open(ports).read().strip()):
            require(job.poll() is None, f"the fleet's card job exited "
                                        f"{job.returncode} before serving")
            require(time.perf_counter() < deadline,
                    "the fleet's card job wrote no port line")
            time.sleep(0.05)
        with open(ports) as f:
            job_label = f"127.0.0.1:{f.read().split()[1]}"
        row = c.submit("kmeans", km["path"], output=o, config={
            "kmeans_k": KMEANS_K, "kmeans_iters": FLEET_KM_ITERS,
            "kmeans_precision": "bf16"})
        while row["state"] in ("queued", "running") and row.get(
                "phase") != "iterate":
            time.sleep(0.02)
            row = c.job(row["id"])
        require(row["state"] == "running",
                f"the fleet's served k-means ended before its fit was seen "
                f"({row['state']}, {row.get('reason')})")
        with open(os.path.join(tmp, "fleet.log"), "w") as flog:
            proc = subprocess.Popen(
                [sys.executable, "-m", "map_oxidize_tpu_torch", "obs",
                 "fleet", "--spool", spool, "--port-file", ports,
                 "--discover-dir", "none", "--archive-dir", arch,
                 "--interval", "0.25", "--iterations", str(FLEET_SWEEPS)],
                env=port_env(), stdout=subprocess.PIPE, stderr=flog,
                text=True)
        first = proc.stdout.readline()
        m = re.search(r"collector on (http://\S+)", first)
        require(m is not None, f"obs fleet printed {first!r}")
        furl = m.group(1)
        deadline = time.perf_counter() + 60
        while True:
            require(proc.poll() is None,
                    f"obs fleet exited {proc.returncode} before it saw both "
                    f"targets up, {label} with device memory")
            with urllib.request.urlopen(furl + "/status", timeout=30) as r:
                st = json.load(r)
            rows = {t["target"]: t for t in st["targets"]}
            mine, theirs = rows.get(label), rows.get(job_label)
            if (mine and theirs and mine["state"] == theirs["state"] == "up"
                    and mine["hbm_bytes"] > 0):
                break
            require(time.perf_counter() < deadline,
                    f"the collector never saw both targets up: "
                    f"{st['targets']}")
            time.sleep(0.1)
        prom = prom_values(urllib.request.urlopen(
            furl + "/metrics", timeout=30).read().decode())
        gauges = {t: {g: prom.get(f'moxt_fleet_target_{g}{{target="{t}"}}')
                      for g in ("up", "hbm_bytes", "hbm_frac", "rows_per_sec",
                                "jobs_running")}
                  for t in (label, job_label)}
        require(gauges[label]["up"] == 1 and gauges[job_label]["up"] == 1
                and (gauges[label]["hbm_bytes"] or 0) > 0
                and (gauges[label]["hbm_frac"] or 0) > 0,
                f"the collector's /metrics: {gauges}")
        target = prom_values(urllib.request.urlopen(
            mine["url"] + "/metrics", timeout=30).read().decode())
        km_launches = target.get("moxt_kernels_kmeans_assign_sum_launches")
        require((km_launches or 0) > 0,
                f"the server's kernels/kmeans_assign_sum/launches "
                f"{km_launches}")
        log(f"obs fleet on {furl}: {label} ({mine['kind']}, phase "
            f"{mine['phase']}) and {job_label} ({theirs['kind']}, phase "
            f"{theirs['phase']}) up; labelled gauges {gauges}; the server "
            f"it found reports kernels/kmeans_assign_sum/launches "
            f"{km_launches:.0f}")
        top = obs_cli(walls, ["top", "--url", furl, "--iterations", "2",
                              "--interval", "0.5", "--no-clear"])
        require("moxt obs fleet —" in top and label in top
                and job_label in top,
                f"obs top rendered no per-target table:\n{top[:2000]}")
        rc = proc.wait(timeout=120)
        require(rc == 0, f"obs fleet exited {rc}")
        stdout, stderr = job.communicate(timeout=600)
        require(job.returncode == 0, f"the fleet's card job exited "
                                     f"{job.returncode}\n{stderr[-3000:]}")
        job_launches = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in (proc, job):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        if proc is not None:
            proc.stdout.close()
    got = np.load(job_out)
    require(got.shape == (KMEANS_K, KMEANS_D) and np.isfinite(got).all(),
            "the fleet's card job's centroids are bad")
    log(f"the fleet's card job: {FLEET_JOB_ITERS} iterations, launches "
        f"{job_launches}")
    row = c.wait(row["id"], timeout_s=600)
    require(row["state"] == "done",
            f"the fleet's served k-means: {row['state']} "
            f"({row.get('reason')})")
    got = np.load(o)
    require(got.shape == (KMEANS_K, KMEANS_D) and np.isfinite(got).all(),
            "the fleet's served k-means centroids are bad")
    row = c.job(row["id"])
    log(serve_job_line("kmeans bf16 (under the fleet)", row, row["metrics"]))
    for argv, names in ((["top"], (label, job_label)),
                        (["where"], (job_label,)),
                        (["trend", "--all-series"], (label, job_label)),
                        (["critpath"], (job_label,))):
        out = obs_cli(walls, [*argv, "--archive", arch])
        require(all(n in out for n in names),
                f"obs {argv[0]} --archive does not name {names}:\n"
                f"{out[:2000]}")
    wall = time.perf_counter() - t0
    log(f"phase 14, the fleet step (in phase 13's server) {wall:.1f} s")
    return {"wall_s": wall, "walls": walls, "gauges": gauges,
            "target_launches": km_launches, "job_launches": job_launches}


def phase_obs(tmp: str, backend: str, km: dict, wc: dict, devmap: dict,
              peaks: dict, serve: dict) -> dict:
    """The offline ``obs`` tooling on card documents (module docstring,
    phase 14): card jobs through the CLI, then every report as a
    subprocess, each timed."""
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "obs14")
    os.makedirs(d)
    env = port_env(MOXT_PEAK_FLOPS=repr(peaks["flops"]),
                   MOXT_PEAK_MEMBW=repr(peaks["membw"]))
    ledger_km, ledger_wc = (os.path.join(d, "ledger_km"),
                            os.path.join(d, "ledger_wc"))
    calib = os.path.join(d, "calib")
    launches = {"kmeans_assign_sum": 0, "tokenize_compact": 0}
    for i in range(OBS_KM_RUNS):
        out = os.path.join(d, f"centroids_{i}.npy")
        got = card_job(f"kmeans {i}", [
            "kmeans", km["path"], "--backend", backend,
            "--kmeans-k", str(KMEANS_K), "--kmeans-iters", str(KMEANS_ITERS),
            "--kmeans-precision", "highest", "--ledger-dir", ledger_km,
            "--calib-dir", calib, "--metrics-out",
            os.path.join(d, f"km{i}.json"), "--output", out, "-q"], env)
        for k in launches:
            launches[k] += got[k]
        require(np.array_equal(np.load(out), km["centroids"]["highest"]),
                f"card job kmeans {i}: centroids differ from phase 4's")
    for i in range(OBS_WC_RUNS):
        out = os.path.join(d, f"final_result_{i}.txt")
        got = card_job(f"wordcount device map {i}", [
            "wordcount", wc["path"], "--backend", backend, "--mapper",
            "device", "--chunk-mb", str(CHUNK_BYTES >> 20), "--ledger-dir",
            ledger_wc, "--metrics-out", os.path.join(d, f"wc{i}.json"),
            "--output", out, "-q"], env)
        for k in launches:
            launches[k] += got[k]
        require(read(out) == read(wc["runs"]["native"]["out"]),
                f"card job wordcount {i}: differs from phase 5's output")
    want = {"kmeans_assign_sum": OBS_KM_RUNS * KMEANS_ITERS,
            "tokenize_compact": OBS_WC_RUNS
            * devmap["wordcount"]["launches"]["tokenize_compact"]}
    require(launches == want, f"phase 14's card jobs launched {launches}, "
                              f"expected {want}")
    log(f"phase 14 card jobs: launches {launches}; k-means centroids "
        f"bit-equal to phase 4's, word counts byte-identical to phase 5's")
    # and the fleet step's one-shot card job (its own process's counts)
    for k in launches:
        launches[k] += serve["fleet"]["job_launches"][k]

    walls: list = []
    km_doc = os.path.join(d, f"km{OBS_KM_RUNS - 1}.json")
    wc_doc = os.path.join(d, f"wc{OBS_WC_RUNS - 1}.json")
    out = obs_cli(walls, ["xprof", km_doc])
    require("kmeans/fit" in out and re.search(r"\(env[)+]", out),
            f"obs xprof names no kmeans/fit against this run's peaks:\n"
            f"{out}")
    rows = {}
    for name, doc, prog in (("kmeans", km_doc, "kmeans/fit"),
                            ("device map", wc_doc, "device_map/tokenize")):
        rep = json.loads(obs_cli(walls, ["xprof", doc, "--json"]))
        r = rows[name] = rep["programs"][prog]
        require(r.get("achieved_flops_per_s") or r.get(
            "achieved_bytes_per_s"), f"{prog}: no achieved rate {r}")
        log(f"obs xprof {name}: {prog} dispatches {r['dispatches']}, "
            f"achieved {r.get('achieved_flops_per_s')} FLOP/s, "
            f"{r.get('achieved_bytes_per_s')} B/s, MFU "
            f"{r.get('mfu_pct')}%, bandwidth {r.get('membw_pct')}%, bound "
            f"{r.get('bound')} against phase 12's peaks "
            f"{rep['peaks']}")
    out = obs_cli(walls, ["xprof", wc_doc])
    require("device_map/tokenize" in out, "obs xprof names no "
                                          "device_map/tokenize")
    for doc in (km_doc, wc_doc):
        at = json.loads(obs_cli(walls, ["where", doc, "--json"]))
        total = (sum(b["ms"] for b in at["buckets"].values())
                 + at["unattributed_ms"])
        require(abs(total - at["wall_ms"]) <= 0.01 + 1e-4 * at["wall_ms"],
                f"obs where: buckets + unattributed {total} != wall "
                f"{at['wall_ms']}")
        log(f"obs where {os.path.basename(doc)}: buckets + unattributed "
            f"{total:.3f} ms = wall {at['wall_ms']:.3f} ms "
            f"({at['unattributed_pct']}% unattributed)")
        obs_cli(walls, ["where", doc])
    obs_cli(walls, ["plan", km_doc])
    # the device map keeps no data-plane audit (as in the JAX package):
    # the audit of phase 5's native word count
    obs_cli(walls, ["data", wc_doc], rc=2)
    out = obs_cli(walls, ["data", os.path.join(tmp, "wc_metrics_auto.json")])
    require("conservation" in out, f"obs data:\n{out[:2000]}")
    obs_cli(walls, ["critpath", km_doc])
    out = obs_cli(walls, ["calib", "show", calib])
    require("kmeans/fit" in out, f"obs calib shows no kmeans/fit:\n{out}")
    obs_cli(walls, ["diff", "--ledger-dir", ledger_km])
    obs_cli(walls, ["diff", "--ledger-dir", ledger_wc])
    slow = os.path.join(d, "ledger_slow")
    os.makedirs(slow)
    with open(os.path.join(ledger_km, "ledger.jsonl")) as f:
        entries = [json.loads(line) for line in f if line.strip()]
    entries[-1]["phases_s"]["iterate"] *= 2
    entries[-1]["metrics"]["time/iterate_s"] *= 2
    with open(os.path.join(slow, "ledger.jsonl"), "w") as f:
        f.write("".join(json.dumps(e) + "\n" for e in entries))
    out = obs_cli(walls, ["diff", "--ledger-dir", slow, "--gate"], rc=3)
    require("phase iterate:" in out, f"obs diff --gate did not flag the "
                                     f"slowed iterate phase:\n{out}")
    out = obs_cli(walls, ["trend", "--ledger-dir", ledger_km])
    require(out.startswith(f"trend: kmeans — {OBS_KM_RUNS} entries"),
            f"obs trend:\n{out[:500]}")
    doc = json.loads(obs_cli(walls, ["trend", "--ledger-dir", ledger_km,
                                     "--json"]))
    require(doc["n_entries"] == OBS_KM_RUNS, f"obs trend --json {doc}")
    out = obs_cli(walls, ["flame", serve["capture"]["bundle"]])
    from map_oxidize_tpu_torch.obs.attrib import BUCKETS

    named = sorted({line.split()[0] for line in out.split(
        "sampled share by attribution bucket", 1)[-1].splitlines()[1:]
        if line.strip()} & set(BUCKETS))
    require(named, f"obs flame names no attribution bucket:\n{out}")
    out = obs_cli(walls, ["xprof", os.path.join(tmp, "crash")])
    require(out.startswith("XLA program observatory"),
            f"obs xprof on the crash bundle:\n{out}")
    wall = time.perf_counter() - t_phase
    walls += serve["fleet"]["walls"]
    log(f"phase 14 reports: {len(walls)} obs subcommands, walls "
        f"{min(w for _, w in walls):.3f}-{max(w for _, w in walls):.3f} s "
        f"(sum {sum(w for _, w in walls):.2f} s); obs flame names buckets "
        f"{named}")
    log(f"phase 14 (obs) wall {wall:.1f} s, plus the fleet step "
        f"{serve['fleet']['wall_s']:.1f} s inside phase 13")
    return {"launches": launches, "wall_s": wall, "walls": walls,
            "rows": rows}

# --- phase 15 ---------------------------------------------------------------

SHARDS = 8                # phase 15: virtual slots on cuda:0
SHARD_PREFIX = 32 << 20   # the all_gather run, the kill and the probe job
SHARD_KILL_CHUNK = 4 << 20
SHARD_KILL_AFTER = 3


def sharded_line(name: str, m: dict, launches: dict, ex: dict) -> str:
    """One sharded job: wall, attribution, ``shuffle/*`` bytes, its comm
    rows, the exchange's and the fold's device time (CUDA events around
    each call) and both kernels' launches."""
    shuffle = {k: v for k, v in m.items() if k.startswith("shuffle/")
               and k != "shuffle/transport"}
    comms = {k: v for k, v in m.items() if k.startswith("comms/")}
    wall_ms = m["attrib/wall_ms"]
    return (f"{name}: job {job_s(m):.2f} s, {m['records_in']} records, "
            f"{m['records_in'] / job_s(m):.0f} /s; {attrib_line(m)}; "
            f"{shuffle}; {comms}; exchange {ex['exchange_ms']:.1f} ms "
            f"({100 * ex['exchange_ms'] / wall_ms:.2f}% of the wall) in "
            f"{ex['exchanges']} calls, fold {ex['merge_ms']:.1f} ms "
            f"({100 * ex['merge_ms'] / wall_ms:.2f}%); launches {launches}")


class ExchangeTimer:
    """CUDA events around every ``_exchange`` and ``shuffle/merge`` call
    of the jobs run inside it (no synchronisation added; read at exit)."""

    def __enter__(self):
        import torch

        import map_oxidize_tpu_torch.parallel.collect as co
        import map_oxidize_tpu_torch.parallel.shuffle as sh

        self.torch, self.sh, self.co = torch, sh, co
        self.real_ex, self.real_merge = sh._exchange, sh._merge_step
        self.ex, self.merge = [], []

        def timed(store, fn):
            def call(*a, **k):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                store.append(ev)
                return out
            return call

        sh._exchange = co._exchange = timed(self.ex, self.real_ex)
        sh.merge_step._fn = timed(self.merge, self.real_merge)
        return self

    def read(self) -> dict:
        self.torch.cuda.synchronize()
        out = {"exchanges": len(self.ex), "merges": len(self.merge),
               "exchange_ms": sum(a.elapsed_time(b) for a, b in self.ex),
               "merge_ms": sum(a.elapsed_time(b) for a, b in self.merge)}
        self.ex.clear()
        self.merge.clear()
        return out

    def __exit__(self, *exc):
        self.sh._exchange = self.co._exchange = self.real_ex
        self.sh.merge_step._fn = self.real_merge
        return False


def stream_shard_rows(stream: dict, S: int) -> dict:
    """{rows: launches} of the S-slot stream over phase 7's file: its
    chunk rounded up to a multiple of S, each chunk split row-wise into S
    blocks, empty blocks of the tail chunk launching nothing
    (``parallel/kmeans.py`` ``kmeans_fit_streamed``)."""
    chunk = -(-stream["chunk_rows"] // S) * S
    r = chunk // S
    n_chunks = -(-STREAM_N // chunk)
    tail = STREAM_N - (n_chunks - 1) * chunk
    shapes = {r: (n_chunks - 1) * S}
    for s in range(S):
        rows = min(max(tail - s * r, 0), r)
        if rows:
            shapes[rows] = shapes.get(rows, 0) + 1
    return shapes


def check_stream_shards(stream: dict, S: int, job_centroids) -> None:
    """One S-slot streamed iteration of phase 7's file against one
    one-shard iteration from the same start: counts equal, centroids
    within 1e-5 * max|x|; and the S-slot call bit-equal to the job's."""
    from map_oxidize_tpu_torch.parallel.kmeans import kmeans_fit_streamed
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_streamed_device,
    )

    path = stream["path"]
    init = np.load(path, mmap_mode="r")[:STREAM_K].copy()
    one, many = [], []
    c1 = kmeans_fit_streamed_device(path, init, iters=1,
                                    chunk_rows=stream["chunk_rows"],
                                    device="cuda", dispatch_batch=1,
                                    partials=one)
    cs = kmeans_fit_streamed(path, init, iters=1,
                             chunk_rows=stream["chunk_rows"], num_shards=S,
                             backend="cuda", dispatch_batch=1,
                             partials=many)
    require(cs.tobytes() == job_centroids.tobytes(),
            f"the S={S} streamed call differs from its job")
    require(np.array_equal(one[0][:, -1], many[0][:, -1]),
            f"S={S} stream counts differ from one shard's in "
            f"{int((one[0][:, -1] != many[0][:, -1]).sum())} centroids")
    bound = 1e-5 * stream["max_abs"]
    err = float(np.abs(cs - c1).max())
    require(err <= bound, f"S={S} stream centroids off by {err}")
    log(f"stream_device S={S} against one one-shard iteration: counts "
        f"equal, centroids max |d| {err:.3g} (bound {bound:.3g}), the "
        f"S={S} call bit-equal to its job")


def phase_sharded(tmp: str, backend: str, km: dict, wc: dict, stream: dict,
                  dataflow: dict, wrappers) -> dict:
    """The sharded engines at S=8 on one card (module docstring, phase
    15): each run against its one-shard phase, byte for byte (k-means:
    counts equal, centroids within 1e-5 * max|x|, run to run bit-equal)."""
    import torch

    import map_oxidize_tpu_torch.runtime.driver as drv
    from map_oxidize_tpu_torch.api import SumReducer
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.obs import calib as _calib
    from map_oxidize_tpu_torch.parallel.mesh import shard_bounds
    from map_oxidize_tpu_torch.runtime import run_job
    from map_oxidize_tpu_torch.workloads.kmeans import assign_points
    from map_oxidize_tpu_torch.workloads.wordcount import WordCountMapper

    t_phase = time.perf_counter()
    S = SHARDS
    out: dict = {"launches": {w.__name__: 0 for w in wrappers}, "runs": {}}

    def counted(name, cfg, workload, timer):
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        r = run_job(cfg, workload)
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        for k, v in launches.items():
            out["launches"][k] += v
        m = r.metrics
        ex = timer.read()
        # the timer wraps private names: a drifted one would read 0
        require(ex["exchanges"] == m.get("shuffle/exchanges", 0),
                f"{name}: {ex['exchanges']} exchanges timed, "
                f"{m.get('shuffle/exchanges', 0)} counted")
        if workload in ("wordcount", "sort"):
            require(ex["exchanges"] > 0, f"{name}: no exchange timed")
        require(ex["merges"] == (ex["exchanges"] if workload == "wordcount"
                                 else 0),
                f"{name}: {ex['merges']} fold merges timed")
        log(sharded_line(name, m, launches, ex) + f"; run_job {wall:.2f} s")
        out["runs"][name] = {"metrics": m, "launches": launches,
                             "wall_s": wall, **ex}
        return r

    native = wc["runs"]["native"]
    prefix = prefix_file(wc["path"], os.path.join(tmp, "shard_prefix.txt"),
                         SHARD_PREFIX)
    with ExchangeTimer() as timer:
        # phase 5's word count at S=8 (all_to_all), byte-identical
        o = os.path.join(tmp, "final_result_s8.txt")
        r = counted("wordcount S=8 all_to_all", JobConfig(
            input_path=wc["path"], output_path=o, backend=backend,
            chunk_bytes=CHUNK_BYTES, top_k=10, metrics=False, num_shards=S,
            exchange_collective="all_to_all"), "wordcount", timer)
        require(read(o) == read(native["out"]),
                "S=8 word count differs from phase 5's")
        nm = native["metrics"]
        m = r.metrics
        out["wc_ratio"] = ((m["records_in"] / job_s(m))
                           / (nm["records_in"] / job_s(nm)))
        log(f"S=8 word count byte-identical to phase 5: "
            f"{out['wc_ratio']:.3f}x phase 5's words/s")
        # the 32 MB prefix under both wire programs
        pre = {}
        for method in ("all_to_all", "all_gather"):
            o = os.path.join(tmp, f"final_result_s8_{method}.txt")
            counted(f"wordcount S=8 {method} (32 MB)", JobConfig(
                input_path=prefix, output_path=o, backend=backend,
                chunk_bytes=SHARD_KILL_CHUNK, metrics=False, num_shards=S,
                exchange_collective=method), "wordcount", timer)
            pre[method] = read(o)
        require(pre["all_to_all"] == pre["all_gather"],
                "all_gather and all_to_all wrote different bytes")
        out["prefix"] = prefix
        out["prefix_out"] = os.path.join(tmp,
                                         "final_result_s8_all_to_all.txt")
        log("32 MB prefix: all_gather byte-identical to all_to_all")

        # phase 4's k-means at S=8, both precisions, twice
        pts = np.load(km["path"], mmap_mode="r")
        scale = float(np.abs(pts).max())
        out["km_ratio"] = {}
        for precision in ("highest", "bf16"):
            cs = []
            for rep in range(2):
                r = counted(f"kmeans {precision} S=8 #{rep + 1}", JobConfig(
                    input_path=km["path"], output_path="", backend=backend,
                    kmeans_k=KMEANS_K, kmeans_iters=KMEANS_ITERS,
                    kmeans_precision=precision, metrics=False, num_shards=S,
                    mapper="device"), "kmeans", timer)
                cs.append(r.centroids)
                require(r.metrics["kmeans_shards"] == S,
                        "k-means ran on another shard count")
                require(backend != "cuda"
                        or out["runs"][f"kmeans {precision} S=8 #{rep + 1}"]
                        ["launches"]["fused_assign_sum"]
                        == S * KMEANS_ITERS,
                        "k-means launched the kernel other than once per "
                        "shard per iteration")
            require(cs[0].tobytes() == cs[1].tobytes(),
                    f"two S=8 {precision} fits differ")
            out.setdefault("km_centroids", {})[precision] = cs[0]
            want = km["centroids"][precision]
            err = float(np.abs(cs[0] - want).max())
            require(err <= 1e-5 * scale,
                    f"S=8 {precision} centroids off by {err}")
            src = (pts if precision == "highest"
                   else round_bf16(np.array(pts)))
            counts = [np.bincount(assign_points(np.asarray(src), c),
                                  minlength=KMEANS_K)
                      for c in (cs[0], want)]
            require((counts[0] == counts[1]).all(),
                    f"S=8 {precision} counts differ from phase 4's")
            ms = (out["runs"][f"kmeans {precision} S=8 #1"]["metrics"]
                  ["time/iter_s"] / KMEANS_ITERS * 1e3)
            out["km_ratio"][precision] = ms / km["ms_per_iter"][precision]
            log(f"kmeans {precision} S=8: {ms:.3f} ms/iter, "
                f"{out['km_ratio'][precision]:.3f}x phase 4's "
                f"{km['ms_per_iter'][precision]:.3f}; counts equal, "
                f"max |d| {err:.3g} (bound {1e-5 * scale:.3g}), run to "
                f"run bit-equal")
        del pts

        # one stream_device iteration of phase 7's file at S=8
        r = counted("stream_device highest S=8 (1 iteration)", JobConfig(
            input_path=stream["path"], output_path="", backend=backend,
            kmeans_k=STREAM_K, kmeans_iters=1, metrics=False,
            num_shards=S, dispatch_batch=1), "kmeans", timer)
        m = r.metrics
        require(m["kmeans_mode"] == "stream_device"
                and m["kmeans_shards"] == S, "the stream did not shard")
        out["stream_ms"] = m["time/feed_s"] * 1e3
        shapes = stream_shard_rows(stream, S)
        require(backend != "cuda"
                or out["runs"]["stream_device highest S=8 (1 iteration)"]
                ["launches"]["fused_assign_sum"] == sum(shapes.values()),
                "the S=8 stream launched the kernel other than once per "
                "non-empty shard per chunk")
        log(f"stream_device S=8: 1 iteration in {out['stream_ms']:.1f} ms "
            f"(phase 7 one-shard {stream['runs']['highest']['ms_per_iter']:.1f}"
            f" ms/iter); per-shard chunk rows {shapes}")
        check_stream_shards(stream, S, r.centroids)

        # phase 10's sort at S=8 over range_dest, byte-identical
        o = os.path.join(tmp, "sort_s8.out")
        r = counted("sort S=8", JobConfig(
            input_path=dataflow["inputs"]["sort"], output_path=o,
            backend=backend, metrics=False, num_shards=S), "sort", timer)
        require(read(o) == read(dataflow["sort"]["host"]["out"]),
                "S=8 sort differs from phase 10's")
        require(r.metrics["sort/splitters"] == S - 1, "no range splitters")
        log("S=8 sort byte-identical to phase 10")

        # phase 11's device-map word count at S=8, byte-identical
        o = os.path.join(tmp, "final_result_device_s8.txt")
        r = counted("device-map wordcount S=8", JobConfig(
            input_path=wc["path"], output_path=o, backend=backend,
            mapper="device", chunk_bytes=CHUNK_BYTES, metrics=False,
            num_shards=S), "wordcount", timer)
        require(read(o) == read(native["out"]),
                "S=8 device map differs from phase 5's")
        groups = -(-r.metrics["chunks"] // S)
        require(backend != "cuda"
                or out["runs"]["device-map wordcount S=8"]["launches"]
                ["tokenize_compact"] == S * groups,
                "tokenize_compact not once per shard per group")
        log(f"S=8 device map byte-identical to phase 5 "
            f"({r.metrics['chunks']} chunks in {groups} groups)")

    # the kernel at the per-shard shapes of the sharded fits above, against
    # its plain version
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    resident = {hi - lo for lo, hi in shard_bounds(KMEANS_N, S) if hi > lo}
    out["configs"] = []
    for rows, k in ([(n, KMEANS_K) for n in sorted(resident)]
                    + [(n, STREAM_K) for n in sorted(shapes)]):
        for precision in ("highest", "bf16"):
            c = check_assign_sum(rows, KMEANS_D, k, precision, False, g)
            c["shard_shape"] = True
            out["configs"].append(c)
            log(f"kmeans_assign_sum per shard n={rows} k={k} "
                f"{precision:7s}: kernel {c['ms']:.4f} ms, plain "
                f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']}), max|dsum| {c['max_abs_err']:.3g}")
    torch.cuda.empty_cache()

    # an S=8 word count killed after 3 chunks, resumed
    class DyingMapper(WordCountMapper):
        mapped = 0

        def map_file(self, *a, **k):
            def gen(it):
                for item in it:
                    if self.mapped == SHARD_KILL_AFTER:
                        raise KeyboardInterrupt("simulated kill")
                    self.mapped += 1
                    yield item
            return gen(super().map_file(*a, **k))

    ck = os.path.join(tmp, "shard_checkpoint")
    o = os.path.join(tmp, "final_result_s8_resumed.txt")
    cfg = JobConfig(input_path=prefix, output_path=o, backend=backend,
                    chunk_bytes=SHARD_KILL_CHUNK, checkpoint_dir=ck,
                    metrics=False, num_shards=S)
    try:
        drv.run_wordcount_job(cfg, DyingMapper(), SumReducer())
        raise AssertionError("the killed S=8 word count ran to its end")
    except KeyboardInterrupt:
        pass
    r = run_job(cfg, "wordcount")
    require(r.metrics.get("checkpoint/chunks_replayed") == SHARD_KILL_AFTER,
            "the S=8 resume replayed another prefix")
    require(read(o) == pre["all_to_all"], "the resumed S=8 word count "
            "differs from the 32 MB prefix's")
    log(f"S=8 word count killed after {SHARD_KILL_AFTER} chunks and "
        f"resumed: byte-identical, {SHARD_KILL_AFTER} chunks replayed")

    # obs calib probe --num-shards 8 into a fresh store at the payload
    # bucket of the next job's exchange; its plan then reads the curve
    store = os.path.join(tmp, "probe_calib")
    cap, row_bytes = _calib.exchange_shape(S, JobConfig.batch_size)
    bucket = _calib.shape_bucket(S * S * cap * (8 + row_bytes))
    t0 = time.perf_counter()
    text = subprocess.run(
        [sys.executable, "-m", "map_oxidize_tpu_torch", "obs", "calib",
         "probe", store, "--num-shards", str(S), "--backend", backend,
         "--buckets", bucket], capture_output=True, text=True, timeout=300,
        env=port_env())
    require(text.returncode == 0, f"obs calib probe: {text.stderr[-2000:]}")
    log(f"obs calib probe ({time.perf_counter() - t0:.1f} s):\n"
        + text.stdout.rstrip())
    r = run_job(JobConfig(input_path=prefix, output_path="",
                          backend=backend, chunk_bytes=SHARD_KILL_CHUNK,
                          metrics=False, num_shards=S, calib_dir=store),
                "wordcount")
    prov = r.metrics.get("plan/exchange_collective_provenance")
    require(prov == "curve", f"the planned job's exchange_collective "
            f"reads {prov!r}, not the probe's curve")
    log(f"planned S=8 job after the probe: plan/exchange_collective "
        f"{r.metrics['plan/exchange_collective']} ({prov}) at {bucket}")
    out["probe_bucket"] = bucket
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15 (sharded) wall {out['wall_s']:.1f} s; launches "
        f"{out['launches']}")
    return out


DIST_PROCS = 2            # phase 16: processes, each with SHARDS/2 slots
DIST_TIMEOUT_S = 600      # per process of one job
REMOTE_TIMEOUT_S = 5.0    # the stage wait before a peer is declared dead
REMOTE_KILL_AFTER = 1     # process 1's committed chunks before its SIGKILL

#: one process of a multi-process job through the port's CLI ``main``; its
#: last stdout line: the process's kernel launches, the bytes it sent over
#: Gloo, its peak device memory and, for k-means, its centroids
DIST_JOB = ("import json, os, signal, sys\n"
            "import torch\n"
            "from map_oxidize_tpu_torch.cli import main\n"
            "from map_oxidize_tpu_torch.ops import kernel_launches\n"
            "from map_oxidize_tpu_torch.parallel import distributed as D\n"
            "from map_oxidize_tpu_torch.parallel.mesh import WIRE\n"
            "got = {}\n"
            "_run = D.run_distributed_job\n"
            "def run(config, workload):\n"
            "    got['r'] = _run(config, workload)\n"
            "    return got['r']\n"
            "D.run_distributed_job = run\n"
            "kill = int(os.environ.get('MOXT_SMOKE_KILL_AFTER', '0'))\n"
            "if kill and '--dist-process-id' in sys.argv and sys.argv[\n"
            "        sys.argv.index('--dist-process-id') + 1] == '1':\n"
            "    # a real SIGKILL mid-stage, after `kill` committed chunks\n"
            "    from map_oxidize_tpu_torch.shuffle import remote as rm\n"
            "    orig, n = rm.RemoteStage.append_chunk, [0]\n"
            "    def bomb(self, *a, **k):\n"
            "        orig(self, *a, **k)\n"
            "        n[0] += 1\n"
            "        if n[0] >= kill:\n"
            "            os.kill(os.getpid(), signal.SIGKILL)\n"
            "    rm.RemoteStage.append_chunk = bomb\n"
            "rc = main(sys.argv[1:])\n"
            "r = got.get('r')\n"
            "c = getattr(r, 'centroids', None)\n"
            "print(json.dumps({'launches': kernel_launches(),\n"
            "    'wire_bytes': WIRE['bytes'], 'wire_calls': WIRE['calls'],\n"
            "    'peak_bytes': torch.cuda.max_memory_allocated()\n"
            "        if torch.cuda.is_initialized() else 0,\n"
            "    'centroids': None if c is None else c.tobytes().hex()}),\n"
            "    flush=True)\n"
            "sys.exit(rc)\n")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dist_job(name: str, argv: list, env=None, expect=(0, 0)):
    """One multi-process job: ``DIST_PROCS`` processes of ``DIST_JOB``
    with ``argv`` plus the dist flags, the spawn retried once on a fresh
    port.  Returns (per-process reports, per-process stdout, wall)."""
    for attempt in range(2):
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", DIST_JOB, *argv, "--dist-coordinator",
             f"127.0.0.1:{port}", "--dist-processes", str(DIST_PROCS),
             "--dist-process-id", str(i)], env=env or port_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(DIST_PROCS)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=DIST_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate())
        wall = time.perf_counter() - t0
        rcs = tuple(p.returncode for p in procs)
        if rcs == tuple(expect):
            break
        log(f"{name}: exit codes {rcs} (attempt {attempt + 1}); stderr "
            f"tails: {[e[-1500:] for _o, e in outs]}")
        require(attempt == 0, f"{name}: exit codes {rcs}, expected {expect}")
    reports, stdouts = [], []
    for (o, _e), rc in zip(outs, rcs):
        lines = o.strip().splitlines()
        reports.append(json.loads(lines[-1]) if rc == 0 else {})
        stdouts.append("\n".join(lines[:-1]) if rc == 0 else o)
    return reports, stdouts, wall


def dist_line(name: str, docs: list, reports: list, wall: float,
              rate_unit: str) -> str:
    """One multi-process job: its wall, its rate over the slowest
    process's job time, the comms bytes and each process's Gloo bytes,
    launches and peak device memory."""
    recs = sum(d["gauges"].get("records_in", 0) for d in docs)
    job = max(d["gauges"]["attrib/wall_ms"] for d in docs) / 1e3
    comms = {k: v for k, v in docs[0]["counters"].items()
             if k.startswith("comms/") and k.endswith("/bytes")}
    return (f"{name}: wall {wall:.2f} s (process start included), job "
            f"{job:.2f} s, {recs / job:.0f} {rate_unit}; comms bytes "
            f"(process 0) {comms}; per process: Gloo bytes sent "
            f"{[r.get('wire_bytes') for r in reports]}, launches "
            f"{[r.get('launches') for r in reports]}, peak device memory "
            f"{[r.get('peak_bytes') for r in reports]}")


def phase_distributed(tmp: str, backend: str, km: dict, wc: dict,
                      dataflow: dict, sharded: dict) -> dict:
    """The multi-process drivers on one card (module docstring, phase
    16): every job against its one-process phase, byte for byte (k-means:
    counts equal, centroids within 1e-5 * max|x|, the processes
    bit-equal)."""
    from map_oxidize_tpu_torch.workloads.kmeans import assign_points

    t_phase = time.perf_counter()
    P, S = DIST_PROCS, SHARDS
    out: dict = {"launches": {"kmeans_assign_sum": 0,
                              "tokenize_compact": 0}, "rates": {}}

    def docs_of(m_out: str) -> list:
        return [json.load(open(f"{m_out}.proc{i}")) for i in range(P)]

    def count(reports):
        for r in reports:
            for k, v in r["launches"].items():
                out["launches"][k] += v

    # --- phase 5's word count -----------------------------------------
    o = os.path.join(tmp, "dist_wc.txt")
    m_out = os.path.join(tmp, "dist_wc_metrics.json")
    t_out = os.path.join(tmp, "dist_wc_trace.json")
    reports, stdouts, wall = dist_job("wordcount P=2", [
        "wordcount", wc["path"], "--num-shards", str(S), "--output", o,
        "--top-k", "10", "--backend", backend, "--metrics-out", m_out,
        "--trace-out", t_out, "-q"])
    count(reports)
    rows = []
    for i in range(P):
        rows.extend(read(f"{o}.part{i}of{P}").splitlines(keepends=True))
    require(b"".join(sorted(rows)) == read(wc["runs"]["native"]["out"]),
            "the 2-process word count's parts differ from phase 5's "
            "final_result.txt")
    del rows
    want = "\n".join(f"{w.decode()}: {c}" for w, c in wc["top"])
    for i, text in enumerate(stdouts):
        require(text.strip().endswith(want), f"process {i} printed another "
                f"top-10:\n{text[-800:]}")
    docs = docs_of(m_out)
    log(dist_line("wordcount P=2 x 4 slots", docs, reports, wall,
                  "words/s"))
    m8 = sharded["runs"]["wordcount S=8 all_to_all"]["metrics"]
    rate = (sum(d["gauges"]["records_in"] for d in docs)
            / (max(d["gauges"]["attrib/wall_ms"] for d in docs) / 1e3))
    out["rates"]["wordcount"] = rate
    out["wc_ratio"] = rate / (m8["records_in"] / job_s(m8))
    log(f"P=2 word count byte-identical to phase 5, the same top-10 on "
        f"both processes; {out['wc_ratio']:.3f}x phase 15's S=8 words/s; "
        f"attrib (process 0): "
        f"{attrib_line({**docs[0]['counters'], **docs[0]['gauges']})}")

    # --- phase 4's k-means at S=8 over 2 processes ---------------------
    pts = np.load(km["path"], mmap_mode="r")
    scale = float(np.abs(pts).max())
    out["km"] = {}
    for precision in ("highest", "bf16"):
        m_out = os.path.join(tmp, f"dist_km_{precision}.json")
        reports, _so, wall = dist_job(f"kmeans {precision} P=2", [
            "kmeans", km["path"], "--num-shards", str(S), "--output", "",
            "--kmeans-k", str(KMEANS_K), "--kmeans-iters",
            str(KMEANS_ITERS), "--kmeans-precision", precision,
            "--backend", backend, "--metrics-out", m_out, "-q"])
        count(reports)
        cs = [np.frombuffer(bytes.fromhex(r["centroids"]),
                            np.float32).reshape(KMEANS_K, -1)
              for r in reports]
        require(cs[0].tobytes() == cs[1].tobytes(),
                f"the two processes' {precision} centroids differ")
        for i, r in enumerate(reports):
            require(backend != "cuda" or r["launches"]["kmeans_assign_sum"]
                    == S // P * KMEANS_ITERS,
                    f"process {i} launched kmeans_assign_sum "
                    f"{r['launches']['kmeans_assign_sum']} times, expected "
                    f"{S // P * KMEANS_ITERS}")
        want = sharded["km_centroids"][precision]
        err = float(np.abs(cs[0] - want).max())
        require(err <= 1e-5 * scale, f"P=2 {precision} centroids off "
                f"phase 15's by {err}")
        src = pts if precision == "highest" else round_bf16(np.array(pts))
        counts = [np.bincount(assign_points(np.asarray(src), c),
                              minlength=KMEANS_K) for c in (cs[0], want)]
        require((counts[0] == counts[1]).all(),
                f"P=2 {precision} counts differ from phase 15's")
        docs = docs_of(m_out)
        ms = max(d["phases_s"]["iterate"] for d in docs) / KMEANS_ITERS * 1e3
        out["km"][precision] = {"ms_per_iter": ms, "max_err": err,
                                "bit_equal": cs[0].tobytes()
                                == want.tobytes()}
        log(dist_line(f"kmeans {precision} P=2 x 4 slots", docs, reports,
                      wall, "points x iterations/s"))
        log(f"P=2 kmeans {precision}: {ms:.3f} ms/iter against phase "
            f"15's S=8 "
            f"{sharded['runs'][f'kmeans {precision} S=8 #1']['metrics']['time/iter_s'] / KMEANS_ITERS * 1e3:.3f}"
            f"; counts equal, max |d| {err:.3g} (bound {1e-5 * scale:.3g}),"
            f" processes bit-equal, bit-equal to phase 15: "
            f"{out['km'][precision]['bit_equal']}; {S // P * KMEANS_ITERS} "
            f"launches per process")
    del pts

    # --- phase 10's sort ----------------------------------------------
    o = os.path.join(tmp, "dist_sort.out")
    m_out = os.path.join(tmp, "dist_sort.json")
    reports, _so, wall = dist_job("sort P=2", [
        "sort", dataflow["inputs"]["sort"], "--num-shards", str(S),
        "--output", o, "--backend", backend, "--metrics-out", m_out, "-q"])
    count(reports)
    want = read(dataflow["sort"]["device"]["out"])
    got = b"".join(read(f"{o}.part{i}of{P}") for i in range(P))
    require(got == want, "the 2-process sort's parts, process-major, "
            "differ from phase 10's card sort")
    del got, want
    docs = docs_of(m_out)
    log(dist_line("sort P=2 x 4 slots", docs, reports, wall, "rows/s"))
    m8 = sharded["runs"]["sort S=8"]["metrics"]
    rate = (sum(d["gauges"]["records_in"] for d in docs)
            / (max(d["gauges"]["attrib/wall_ms"] for d in docs) / 1e3))
    out["rates"]["sort"] = rate
    log(f"P=2 sort byte-identical to phase 10 (process-major); "
        f"{rate / (m8['records_in'] / job_s(m8)):.3f}x phase 15's S=8 "
        f"rows/s")

    # --- the remote-staged word count, process 1 killed ----------------
    o = os.path.join(tmp, "dist_remote.txt")
    stage = os.path.join(tmp, "dist_remote.stage")
    reports, _so, wall = dist_job("remote-staged wordcount", [
        "wordcount", sharded["prefix"], "--num-shards", str(S), "--output",
        o, "--chunk-mb", str(SHARD_KILL_CHUNK >> 20), "--backend", backend,
        "--shuffle-transport", "remote", "--remote-stage-dir", stage,
        "--remote-stage-timeout", str(REMOTE_TIMEOUT_S), "-q"],
        env=port_env(MOXT_SMOKE_KILL_AFTER=str(REMOTE_KILL_AFTER)),
        expect=(0, -9))
    rows = []
    for i in range(P):
        rows.extend(read(f"{o}.part{i}of{P}").splitlines(keepends=True))
    require(b"".join(sorted(rows)) == read(sharded["prefix_out"]),
            "the recovered remote-staged word count differs from the "
            "one-process bytes")
    require(os.path.exists(os.path.join(stage, "claim.proc1")),
            "process 0 never claimed the killed process 1")
    rec = json.load(open(os.path.join(stage, "manifest.proc1.rec.json")))
    dead = json.load(open(os.path.join(stage, "manifest.proc1.json")))
    require(rec["final"] and rec["staged_by"] == 0
            and len(dead["chunks_done"]) == REMOTE_KILL_AFTER,
            "the recovery manifest does not cover the killed process")
    log(f"remote-staged word count of the 32 MB prefix: process 1 "
        f"SIGKILLed after {REMOTE_KILL_AFTER} committed chunk, process 0 "
        f"claimed it and re-mapped chunks {rec['chunks_done']}; the parts "
        f"byte-identical to the one-process run; wall {wall:.2f} s "
        f"(the {REMOTE_TIMEOUT_S:.0f} s stage wait included)")

    # --- obs merge and obs critpath over the word count's shards -------
    for argv in (["merge", t_out], ["critpath", t_out]):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "map_oxidize_tpu_torch", "obs", *argv],
            capture_output=True, text=True, timeout=300, env=port_env())
        require(res.returncode == 0, f"obs {argv[0]}: exit "
                f"{res.returncode}: {res.stderr[-1500:]}")
        log(f"obs {argv[0]} over the P=2 shards: exit 0 in "
            f"{time.perf_counter() - t0:.2f} s:\n" + res.stdout.rstrip())
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 16 (distributed) wall {out['wall_s']:.1f} s; children's "
        f"launches {out['launches']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact
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
    wrappers = [fused_assign_sum, tokenize_compact]
    configs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="moxt_smoke_") as tmp:
        corpus = write_corpus(tmp, CORPUS_BYTES, VOCAB)
        tok = phase_tokenize_kernel(corpus, resources)
        phase_trace_dir(tmp, "cuda")
        km = phase_kmeans(tmp, "cuda", KMEANS_N, KMEANS_D, KMEANS_K,
                          KMEANS_ITERS, wrappers)
        wc = phase_wordcount(tmp, "cuda", corpus, wrappers)
        wc_resume = phase_resume_wordcount(tmp, "cuda", wc, wrappers)
        km_resume = phase_resume_kmeans(tmp, "cuda", km, wrappers)
        stream = phase_stream(tmp, "cuda", wrappers, torch.Generator(
            device="cuda").manual_seed(SEED + 5))
        phase_flight(tmp, "cuda")
        collect = phase_collect(tmp, "cuda", wc, wrappers)
        dataflow = phase_dataflow(tmp, "cuda", wrappers)
        devmap = phase_device_map(tmp, "cuda", wc, collect, wrappers)
        plan = phase_plan(tmp, "cuda", stream, km, km_resume, wrappers)
        serve = phase_serve(tmp, km, wc, devmap)
        obs = phase_obs(tmp, "cuda", km, wc, devmap, plan["peaks"], serve)
        sharded = phase_sharded(tmp, "cuda", km, wc, stream, dataflow,
                                wrappers)
        dist = phase_distributed(tmp, "cuda", km, wc, dataflow, sharded)
    if km["launches"]["fused_assign_sum"] != 2 * KMEANS_ITERS:
        raise AssertionError(f"kmeans path launched the kernel "
                             f"{km['launches']} times, expected "
                             f"{2 * KMEANS_ITERS}")
    # the counted runs of both k-means paths: phase 4's, phase 7's and
    # phase 12's, the served jobs of phases 13 and 14 (the server
    # process's own counts, from 0 at its start) and phase 14's card jobs
    # (each process's own counts)
    launches = (km["launches"]["fused_assign_sum"]
                + stream["launches"]["fused_assign_sum"]
                + plan["launches"]["fused_assign_sum"]
                + serve["launches"]["kmeans_assign_sum"]
                + obs["launches"]["kmeans_assign_sum"]
                + sharded["launches"]["fused_assign_sum"]
                + dist["launches"]["kmeans_assign_sum"])
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
        "resources": {k: v for k, v in resources.items()
                      if not k.startswith("tokenize_compact")},
        "configs": configs + stream["configs"] + sharded["configs"],
    }, {
        "name": "tokenize_compact",
        "route": "cuda",
        "source": "map_oxidize_tpu_torch/ops/csrc/tokenize_compact.cu",
        "replaces": "map_oxidize_tpu/ops/device_tokenize.py:85",
        "replaces_note": "tokenize_hash (:85) + _compact_tokens (:124), "
                         "XLA programs, not a Pallas kernel",
        "launches": (devmap["wordcount"]["launches"]["tokenize_compact"]
                     + serve["launches"]["tokenize_compact"]
                     + obs["launches"]["tokenize_compact"]
                     + sharded["launches"]["tokenize_compact"]),
        "max_abs_err": tok["max_abs_err"],
        "ms": tok["ms"],
        "plain_ms": tok["plain_ms"],
        "bound_ms": tok["bound_ms"],
        "bound_by": tok["bound_by"],
        "library_ms": None,
        "yardstick_ms": tok["yardstick_ms"],
        "yardstick": tok["yardstick"],
        "checked_against_plain": True,
        "checked": tok["checked"],
        "split": tok["split"],
        "launches_per_call": tok["launches_per_call"],
        "layout": tok["layout"],
        "resources": tok["resources"],
    }]
    wc_rate = {name: run["metrics"]["records_in"] / job_s(run["metrics"])
               for name, run in wc["runs"].items()}
    log(f"kmeans ms/iter {km['ms_per_iter']}, resumed "
        f"{km_resume['ms_per_iter']}, kernel ms per call "
        f"{km['kernel_ms']}; stream_device ms/iter "
        f"{ {p: r['ms_per_iter'] for p, r in stream['runs'].items()} }, "
        f"device-resident on that file "
        f"{ {p: r['device_ms_per_iter'] for p, r in stream['runs'].items()} }"
        f"; wordcount words/s {wc_rate}, resumed "
        f"{wc_resume['mapped'] / job_s(wc_resume['metrics']):.0f} "
        f"(tokens mapped in that run over its job time); "
        f"bigram words/s "
        f"{ {n: round(b['metrics']['records_in'] / job_s(b['metrics'])) for n, b in collect['bigram'].items()} }, "
        f"invertedindex words/s "
        f"{ {n: round(b['metrics']['records_in'] / job_s(b['metrics'])) for n, b in collect['invertedindex'].items()} }, "
        f"card sort {collect['card_sort']}, distinct estimate "
        f"{collect['distinct']['estimate']:.1f} of "
        f"{collect['distinct']['exact']}, phase 9 "
        f"{collect['wall_s']:.1f} s; dataflow rows/s "
        f"{ {w + ' ' + n: round(b['metrics']['records_in'] / job_s(b['metrics'])) for w in ('sort', 'join', 'sessionize') for n, b in dataflow[w].items()} }, "
        f"phase 10 {dataflow['wall_s']:.1f} s; device-map words/s "
        f"{devmap['wordcount']['metrics']['records_in'] / job_s(devmap['wordcount']['metrics']):.0f}, "
        f"tokenize_compact {tok['ms']:.3f} ms per 32 MiB chunk, phase 11 "
        f"{devmap['wall_s']:.1f} s; phase 12 auto B "
        f"{ {p: (r['cold']['dispatch']['batch'], r['warm']['dispatch']['batch']) for p, r in plan['runs'].items()} }"
        f" (cold, warm); served words/s {serve['rates']} (concurrent), "
        f"phase 13 {serve['wall_s']:.1f} s (its fleet step "
        f"{serve['fleet']['wall_s']:.1f} s); phase 14 "
        f"{obs['wall_s']:.1f} s; phase 15 S=8 word count "
        f"{sharded['wc_ratio']:.3f}x phase 5, k-means ms/iter "
        f"{ {p: round(v, 3) for p, v in sharded['km_ratio'].items()} }x "
        f"phase 4, {sharded['wall_s']:.1f} s; phase 16 P=2 word count "
        f"{dist['wc_ratio']:.3f}x phase 15's S=8, k-means ms/iter "
        f"{ {p: round(v['ms_per_iter'], 3) for p, v in dist['km'].items()} }"
        f", {dist['wall_s']:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
