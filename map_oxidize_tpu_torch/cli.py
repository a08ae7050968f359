"""Command-line driver of the port:

    python -m map_oxidize_tpu_torch wordcount corpus.txt --top-k 10
    python -m map_oxidize_tpu_torch bigram corpus.txt --reduce-mode fold
    python -m map_oxidize_tpu_torch invertedindex corpus.txt \\
        --collect-sort device --output postings.txt
    python -m map_oxidize_tpu_torch distinct corpus.txt --hll-precision 14
    python -m map_oxidize_tpu_torch wordcount corpus.txt --mapper device
    python -m map_oxidize_tpu_torch sort records.npy --output sorted.bin
    python -m map_oxidize_tpu_torch join left.npy --join-input right.npy \\
        --output matches.bin
    python -m map_oxidize_tpu_torch sessionize events.npy --session-gap 3600 \\
        --output sessions.txt
    python -m map_oxidize_tpu_torch kmeans points.npy --kmeans-k 256 \\
        --kmeans-iters 10 --kmeans-precision bf16
    python -m map_oxidize_tpu_torch wordcount corpus.txt --backend cpu
    python -m map_oxidize_tpu_torch wordcount corpus.txt --checkpoint-dir ck
    python -m map_oxidize_tpu_torch wordcount corpus.txt \\
        --metrics-out m.json --trace-out t.json --ledger-dir ledger
    python -m map_oxidize_tpu_torch serve --port 8321 --spool-dir spool
    python -m map_oxidize_tpu_torch submit --url http://127.0.0.1:8321 \\
        --wait wordcount /data/corpus.txt
    python -m map_oxidize_tpu_torch obs xprof m.json
    python -m map_oxidize_tpu_torch obs trend --ledger-dir ledger
    python -m map_oxidize_tpu_torch wordcount corpus.txt --num-shards 8 \\
        --dist-coordinator 127.0.0.1:29500 --dist-processes 2 \\
        --dist-process-id 0          # and id 1 in a second process

Flag names and defaults are the JAX package's CLI's; ``--backend`` takes
``cuda`` (the default, which needs a CUDA device) or ``cpu``.  ``serve``
and ``submit`` are the resident job service's (:mod:`.serve.cli`), ``obs``
the observability artifact tools' (:mod:`.obs.cli`).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from map_oxidize_tpu_torch.config import WORKLOADS, JobConfig
from map_oxidize_tpu_torch.shuffle.base import TRANSPORTS
from map_oxidize_tpu_torch.utils.logging import configure, get_logger

_log = get_logger(__name__)


def _dispatch_batch_arg(v: str) -> int:
    """``--dispatch-batch {auto,N}``: 'auto' -> 0, else a positive count."""
    if v == "auto":
        return 0
    try:
        n = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--dispatch-batch takes 'auto' or a positive integer, got {v!r}")
    if n < 1:
        raise argparse.ArgumentTypeError(
            "--dispatch-batch must be >= 1 (or 'auto')")
    return n


def build_parser() -> argparse.ArgumentParser:
    from map_oxidize_tpu_torch import __version__

    p = argparse.ArgumentParser(
        prog="map_oxidize_tpu_torch",
        description="MapReduce on PyTorch/CUDA (the port of map_oxidize_tpu)")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("workload", choices=list(WORKLOADS),
                   help="built-in workload to run")
    p.add_argument("input", help="input path: a text corpus, a .npy "
                                 "points file for kmeans, or a .npy "
                                 "record file for sort, join (left side) "
                                 "and sessionize")
    p.add_argument("--output", default="final_result.txt",
                   help="final result path")
    p.add_argument("--top-k", type=int, default=10,
                   help="top-k words to report")
    p.add_argument("--map-workers", type=int, default=8,
                   help="host map threads (reference: 8)")
    p.add_argument("--num-chunks", type=int, default=0,
                   help="fixed chunk count with round-robin line chunking "
                        "(reference compat mode); 0 = streaming byte ranges")
    p.add_argument("--chunk-mb", type=int, default=32, help="streamed chunk size")
    p.add_argument("--batch-size", type=int, default=1 << 20,
                   help="device feed batch rows")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="bounded-prefetch pipeline depth: chunks of host "
                        "read+tokenize allowed to run ahead of the device "
                        "feed (1 = strictly serial; outputs are "
                        "byte-identical at any depth)")
    p.add_argument("--dispatch-batch", type=_dispatch_batch_arg, default=0,
                   metavar="{auto,N}",
                   help="full feed batches shipped per host->device "
                        "transfer (auto = 1); outputs are identical at "
                        "any value")
    p.add_argument("--key-capacity", type=int, default=1 << 22,
                   help="max distinct keys on device")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--num-shards", type=int, default=0,
                   help="device mesh shards (0 = all local devices, 1 = "
                        "single; more than the devices deals virtual "
                        "slots over them)")
    p.add_argument("--tokenizer", choices=["ascii", "unicode"],
                   default="ascii")
    p.add_argument("--mapper", choices=["auto", "device", "native", "python"],
                   default="auto",
                   help="map-phase placement.  wordcount, bigram: C++ "
                        "host loop, pure Python, or tokenize and count on "
                        "the device (ascii only; auto: native; other "
                        "workloads take native for device).  kmeans: "
                        "device-resident (device), "
                        "resident or streamed through the device by fit "
                        "(auto), host assign (native, python)")
    p.add_argument("--no-native", action="store_true",
                   help="disable the C++ tokenizer hot loop (with --mapper "
                        "auto: the Python map)")
    p.add_argument("--reduce-mode", choices=["auto", "fold", "collect"],
                   default="auto",
                   help="reduce engine: streaming device fold vs host "
                        "collect+one-sort (auto: by the workload's key-space "
                        "width — collect for bigram, fold otherwise)")
    p.add_argument("--collect-sort", choices=["auto", "host", "device"],
                   default="auto",
                   help="inverted-index pair sort placement: the host "
                        "radix, or the pairs on the device and one sort "
                        "there (auto: host)")
    p.add_argument("--collect-max-rows", type=int, default=0,
                   help="resident-row cap for the collect engines before "
                        "the disk-bucket spill (counts, values, and "
                        "(key,doc) pairs all spill); 0 = engine defaults")
    p.add_argument("--shuffle-transport",
                   choices=list(TRANSPORTS), default="auto",
                   help="where collect-engine shuffle rows stage: hbm = "
                        "strictly resident (the row cap is a hard error), "
                        "disk = top-bits disk buckets from the first row, "
                        "hybrid = resident until the cap then demote to "
                        "disk mid-job, pipelined = hybrid's placement plus "
                        "the push cadence (see --push-combine), remote = "
                        "staged from the first row like disk.  auto routes "
                        "on corpus size vs --collect-max-rows (estimated "
                        "rows past the cap pick disk, else hybrid)")
    p.add_argument("--push-combine", choices=["auto", "on", "off"],
                   default="auto",
                   help="map-side combiner: combine each push window's "
                        "rows (sum/min/max reducers) before the feed. "
                        "auto = on when the transport resolves to "
                        "pipelined; outputs are byte-identical either way")
    p.add_argument("--remote-stage-dir", default="",
                   help="remote transport: shared-filesystem stage "
                        "directory every process can reach (default: "
                        "<output>.stage)")
    p.add_argument("--remote-stage-timeout", type=float, default=60.0,
                   help="remote transport: seconds to wait for peers' "
                        "final stage manifests before declaring them "
                        "dead and taking over their partitions")
    p.add_argument("--join-input", default="",
                   help="join: the RIGHT/probe record corpus (.npy of "
                        "(u64 key, u64 payload) rows, payloads < 2^63; "
                        "the positional input is the left/build side)")
    p.add_argument("--session-gap", type=int, default=3600,
                   help="sessionize: consecutive same-key events more "
                        "than this far apart (timestamp units) start a "
                        "new session")
    p.add_argument("--sort-sample", type=int, default=4096,
                   help="sort: target key-sample size for the range "
                        "splitters (deterministic strided sample; "
                        "larger balances skew better)")
    p.add_argument("--rescan-full", action="store_true",
                   help="hash-only mode: rescan the whole corpus when "
                        "resolving winner strings (extends the collision "
                        "byte-check to every occurrence) instead of "
                        "stopping once all queried keys are found")
    p.add_argument("--hll-precision", type=int, default=14,
                   help="distinct: HyperLogLog precision p (2^p registers; "
                        "rse ~1.04/sqrt(2^p))")
    p.add_argument("--kmeans-k", type=int, default=16,
                   help="k-means cluster count (init: first k points)")
    p.add_argument("--kmeans-iters", type=int, default=1,
                   help="k-means iterations")
    p.add_argument("--kmeans-precision", choices=["highest", "bf16"],
                   default="highest",
                   help="k-means score-product precision: plain f32, or "
                        "bf16 operands with f32 accumulation")
    p.add_argument("--kmeans-fit-bytes", type=int, default=0,
                   help="kmeans mapper=auto device-fit budget in bytes; "
                        "past it the job streams through the device "
                        "(0 = probe the device's memory)")
    p.add_argument("--dist-coordinator", default="",
                   help="multi-process: rendezvous address host:port (same "
                        "on every process); enables the Gloo process "
                        "group")
    p.add_argument("--dist-processes", type=int, default=0,
                   help="multi-process: total process count")
    p.add_argument("--dist-process-id", type=int, default=-1,
                   help="multi-process: this process's id (0-based)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for resumable map-output checkpoints "
                        "(kmeans: per-iteration snapshots; a SUCCESSFUL "
                        "run deletes its snapshot, so continuing training "
                        "past a completed run needs --keep-intermediates "
                        "on the earlier run)")
    p.add_argument("--keep-intermediates", action="store_true")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the run (host "
                        "activity, and the device's kernels and copies on "
                        "cuda) into this directory as Chrome trace JSON")
    p.add_argument("--trace-out", default=None,
                   help="capture framework spans (phases, per-block feeds, "
                        "flushes, prefetch handoffs) and write Chrome "
                        "trace-event JSON here — load in chrome://tracing "
                        "or Perfetto")
    p.add_argument("--metrics-out", default=None,
                   help="write the structured metrics document (phase "
                        "timings, counters, gauges, histograms) here as "
                        "JSON")
    p.add_argument("--ledger-dir", default=None,
                   help="append this job's summary (metrics, phase times, "
                        "config hash, version) to <dir>/ledger.jsonl, the "
                        "JAX package's run-ledger format")
    p.add_argument("--crash-dir", default=None,
                   help="failure flight recorder: on an abort, dump a "
                        "post-mortem bundle (config, metrics-so-far, "
                        "open-span-closed trace, traceback) under this "
                        "directory before the error propagates")
    p.add_argument("--progress", action="store_true",
                   help="log periodic progress lines (rows/sec, percent "
                        "done, ETA, phase) for long streamed jobs")
    p.add_argument("--progress-interval", type=float, default=10.0,
                   help="minimum seconds between --progress lines")
    p.add_argument("--no-data-audit", action="store_true",
                   help="disable the data-plane observatory (per-"
                        "partition row-conservation audits, key-skew "
                        "telemetry, data/* gauges — obs/dataplane.py); "
                        "on by default, pure host-side accounting")
    p.add_argument("--hbm-sample-interval", type=float, default=0.0,
                   help="device sampler: seconds between background reads "
                        "of the live device memory (hbm/live_bytes "
                        "watermark gauges); 0 = off")
    p.add_argument("--stall-factor", type=float, default=0.0,
                   help="stall detector: warn with the open span names "
                        "when no chunk completes within this multiple of "
                        "the median chunk time; 0 = off")
    p.add_argument("--obs-port", type=int, default=-1,
                   help="live telemetry: serve /metrics (Prometheus), "
                        "/status, /series, /alerts and /healthz on this "
                        "127.0.0.1 port while the job runs (0 = "
                        "ephemeral, port logged); -1 = off")
    p.add_argument("--obs-sample-interval", type=float, default=0.0,
                   help="time-series recorder: seconds between ring-"
                        "buffer snapshots of every counter/gauge/"
                        "histogram quantile (metrics doc `series` "
                        "section + /series endpoint); 0 = off unless "
                        "--obs-port is set (then 1s)")
    p.add_argument("--obs-spool", default=None,
                   help="fleet-discovery spool: where the live obs "
                        "server publishes its port record (default: "
                        "$MOXT_OBS_SPOOL or a per-user spool under the "
                        "temporary directory; 'none' disables publishing)")
    p.add_argument("--slo-rules", default=None,
                   help="SLO/alerting rule set for the live plane: a "
                        "JSON file path or inline JSON (a list extends "
                        "the built-in defaults; {\"defaults\": false, "
                        "\"rules\": [...]} replaces them).  Evaluated "
                        "whenever the time-series recorder runs; firing "
                        "rules emit [alert] lines, serve at /alerts, "
                        "and write incident bundles")
    p.add_argument("--incident-dir", default=None,
                   help="where SLO incident bundles land (series window "
                        "+ status snapshot per alert firing); default: "
                        "the --crash-dir, if any")
    p.add_argument("--profile-dir", default=None,
                   help="where on-demand POST /profile deep captures "
                        "land (torch.profiler device trace + host "
                        "sampling stacks); default: next to the crash "
                        "bundles / metrics document")
    p.add_argument("--host-sample-hz", type=float, default=50.0,
                   help="host sampling profiler rate during a /profile "
                        "capture (Python stacks per second)")
    p.add_argument("--plan", choices=["auto", "off"], default="auto",
                   help="job planner: auto (default) solves the tunable "
                        "knobs from the calibration store's measured "
                        "curves before the run and records the plan "
                        "(per-knob provenance curve/memo/default/pinned, "
                        "and a predicted wall scored against the measured "
                        "one as plan/model_error_pct); off skips it")
    p.add_argument("--calib-dir", default=None,
                   help="persistent calibration store: accumulate this "
                        "run's per-program dispatch/compute and its wall "
                        "attribution into <dir>/calib.json (merged "
                        "atomically across runs); the next run's planner "
                        "and auto dispatch batch read it")
    p.add_argument("--exchange-collective",
                   choices=["auto", "all_to_all", "all_gather"],
                   default="auto",
                   help="shuffle exchange wire program: auto (default) "
                        "lets the planner pick from the calibration "
                        "store's measured curves (monolithic all_to_all "
                        "vs the decomposed all_gather+slice resharding; "
                        "falls back to all_to_all with a named reason on "
                        "a cold store); explicit values pin.  Outputs "
                        "are byte-identical either way")
    p.add_argument("--calib-min-samples", type=int, default=3,
                   help="chooser evidence floor: sampled latencies "
                        "required in the exact payload bucket before a "
                        "store curve may steer the exchange collective")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def config_from_args(args: argparse.Namespace) -> JobConfig:
    return JobConfig(
        input_path=args.input,
        output_path=args.output,
        top_k=args.top_k,
        num_map_workers=args.map_workers,
        num_chunks=args.num_chunks,
        chunk_bytes=args.chunk_mb * 1024 * 1024,
        batch_size=args.batch_size,
        pipeline_depth=args.pipeline_depth,
        dispatch_batch=args.dispatch_batch,
        key_capacity=args.key_capacity,
        backend=args.backend,
        tokenizer=args.tokenizer,
        mapper="python" if args.no_native and args.mapper == "auto"
               else args.mapper,
        use_native=not args.no_native,
        reduce_mode=args.reduce_mode,
        collect_sort=args.collect_sort,
        collect_max_rows=args.collect_max_rows,
        shuffle_transport=args.shuffle_transport,
        push_combine=args.push_combine,
        remote_stage_dir=args.remote_stage_dir,
        remote_stage_timeout_s=args.remote_stage_timeout,
        rescan_full=args.rescan_full,
        hll_precision=args.hll_precision,
        join_input_path=args.join_input,
        session_gap=args.session_gap,
        sort_sample=args.sort_sample,
        kmeans_k=args.kmeans_k,
        kmeans_iters=args.kmeans_iters,
        kmeans_precision=args.kmeans_precision,
        kmeans_device_fit_bytes=args.kmeans_fit_bytes,
        dist_coordinator=args.dist_coordinator,
        dist_num_processes=args.dist_processes,
        dist_process_id=args.dist_process_id,
        checkpoint_dir=args.checkpoint_dir,
        keep_intermediates=args.keep_intermediates,
        trace_dir=args.trace_dir,
        trace_out=args.trace_out,
        metrics_out=args.metrics_out,
        ledger_dir=args.ledger_dir,
        crash_dir=args.crash_dir,
        progress=args.progress,
        progress_interval_s=args.progress_interval,
        data_audit=not args.no_data_audit,
        hbm_sample_s=args.hbm_sample_interval,
        stall_warn_factor=args.stall_factor,
        obs_port=args.obs_port,
        obs_sample_s=args.obs_sample_interval,
        obs_spool=args.obs_spool,
        slo_rules=args.slo_rules,
        incident_dir=args.incident_dir,
        profile_dir=args.profile_dir,
        host_sample_hz=args.host_sample_hz,
        plan=args.plan,
        calib_dir=args.calib_dir,
        calib_min_samples=args.calib_min_samples,
        exchange_collective=args.exchange_collective,
        num_shards=args.num_shards,
    ).validate()


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        # the reader closed the pipe early (``... | head``, the way the
        # obs reports are read): it got what it wanted.  Point stdout at
        # devnull so the interpreter's exit flush cannot raise again.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0


def _main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "obs":
        # the artifact tools: host-side file and HTTP work, no device
        from map_oxidize_tpu_torch.obs.cli import obs_main

        return obs_main(argv[1:])
    if argv and argv[0] == "serve":
        # the resident job server (serve/): a long-lived process, jobs
        # arrive over HTTP; none of the one-shot workload flags apply
        from map_oxidize_tpu_torch.serve.cli import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "submit":
        # the client side: HTTP only, no device
        from map_oxidize_tpu_torch.serve.cli import submit_main

        return submit_main(argv[1:])
    args = build_parser().parse_args(argv)
    configure(logging.DEBUG if args.verbose
              else logging.WARNING if args.quiet else logging.INFO)
    try:
        config = config_from_args(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not os.path.isfile(config.input_path):
        print(f"error: cannot open input {config.input_path!r}",
              file=sys.stderr)
        return 2
    if args.workload == "join" and not os.path.isfile(
            config.join_input_path):
        print(f"error: join needs --join-input; cannot open "
              f"{config.join_input_path!r}", file=sys.stderr)
        return 2
    if config.keep_intermediates and not config.checkpoint_dir:
        _log.warning("--keep-intermediates has no effect without "
                     "--checkpoint-dir (there are no intermediates: map "
                     "outputs stay on device)")
    if config.dist_coordinator:
        return _run_distributed(config, args.workload)
    from map_oxidize_tpu_torch.runtime import run_job

    result = run_job(config, args.workload)
    print(result.top_report(config.top_k))
    return 0


def _run_distributed(config: JobConfig, workload: str) -> int:
    """One process of a multi-process job (``--dist-coordinator``): the
    job over the process group, then what the JAX package's CLI prints
    for it; the group is shut down after the last collective."""
    from map_oxidize_tpu_torch.parallel.distributed import (
        partition_output_path,
        run_distributed_job,
        shutdown_distributed,
    )

    r = run_distributed_job(config, workload)
    shutdown_distributed()
    P = config.dist_num_processes
    part = (partition_output_path(config.output_path,
                                  config.dist_process_id, P)
            if config.output_path else None)
    if workload in ("sort", "join", "sessionize"):
        print(r.top_report(config.top_k) + f" ({P} processes)")
        if part:
            _log.info(
                "process %d wrote its partition to %s (the %d parts "
                "concatenate%s)", config.dist_process_id, part, P,
                ", process-major, into the globally sorted artifact"
                if workload == "sort" else " disjointly")
        return 0
    if workload == "kmeans":
        c = r.centroids
        print(f"k-means: {c.shape[0]} centroids, dim {c.shape[1]}, "
              f"{config.kmeans_iters} iterations ({P} processes)")
        return 0
    if part and workload != "distinct":
        _log.info(
            "process %d wrote its hash partition to %s (concatenate the "
            "%d parts and sort for the single-file artifact)",
            config.dist_process_id, part, P)
    if workload == "distinct":
        print(f"distinct tokens ~ {r.estimate:,.0f} ({P} processes)")
        return 0
    unit = "docs" if workload == "invertedindex" else ""
    print(f"Top {config.top_k} keys ({r.n_keys} distinct):")
    for h, word, c in r.top:
        name = (word.decode("utf-8", "replace") if word is not None
                else f"{h:#018x}")
        print(f"{name}: {c}{' ' + unit if unit else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
