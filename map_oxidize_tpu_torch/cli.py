"""Command-line driver of the port:

    python -m map_oxidize_tpu_torch wordcount corpus.txt --top-k 10
    python -m map_oxidize_tpu_torch kmeans points.npy --kmeans-k 256 \\
        --kmeans-iters 10 --kmeans-precision bf16
    python -m map_oxidize_tpu_torch wordcount corpus.txt --backend cpu
    python -m map_oxidize_tpu_torch wordcount corpus.txt --checkpoint-dir ck

Flag names and defaults are the JAX package's CLI's; ``--backend`` takes
``cuda`` (the default, which needs a CUDA device) or ``cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from map_oxidize_tpu_torch.config import WORKLOADS, JobConfig
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
    p.add_argument("input", help="input path: a text corpus, or a .npy "
                                 "points file for kmeans")
    p.add_argument("--output", default="final_result.txt",
                   help="final result path")
    p.add_argument("--top-k", type=int, default=10,
                   help="top-k words to report")
    p.add_argument("--map-workers", type=int, default=8,
                   help="host map threads (reference: 8)")
    p.add_argument("--num-chunks", type=int, default=0,
                   help="fixed chunk count with round-robin line chunking "
                        "(reference compat mode); 0 = streaming byte ranges")
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
    p.add_argument("--tokenizer", choices=["ascii", "unicode"],
                   default="ascii")
    p.add_argument("--mapper", choices=["auto", "device", "native", "python"],
                   default="auto",
                   help="map-phase placement.  wordcount: C++ host loop "
                        "or pure Python (auto: native); device is not "
                        "ported yet.  kmeans: device-resident (device), "
                        "resident or streamed through the device by fit "
                        "(auto), host assign (native, python)")
    p.add_argument("--kmeans-k", type=int, default=16,
                   help="k-means cluster count (init: first k points)")
    p.add_argument("--kmeans-iters", type=int, default=1,
                   help="k-means iterations")
    p.add_argument("--kmeans-precision", choices=["highest", "bf16"],
                   default="highest",
                   help="k-means score-product precision: plain f32, or "
                        "bf16 operands with f32 accumulation")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for resumable map-output checkpoints "
                        "(kmeans: per-iteration snapshots; a SUCCESSFUL "
                        "run deletes its snapshot, so continuing training "
                        "past a completed run needs --keep-intermediates "
                        "on the earlier run)")
    p.add_argument("--keep-intermediates", action="store_true")
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
        batch_size=args.batch_size,
        pipeline_depth=args.pipeline_depth,
        dispatch_batch=args.dispatch_batch,
        key_capacity=args.key_capacity,
        backend=args.backend,
        tokenizer=args.tokenizer,
        mapper=args.mapper,
        kmeans_k=args.kmeans_k,
        kmeans_iters=args.kmeans_iters,
        kmeans_precision=args.kmeans_precision,
        checkpoint_dir=args.checkpoint_dir,
        keep_intermediates=args.keep_intermediates,
    ).validate()


def main(argv: list[str] | None = None) -> int:
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
    if config.keep_intermediates and not config.checkpoint_dir:
        _log.warning("--keep-intermediates has no effect without "
                     "--checkpoint-dir (there are no intermediates: map "
                     "outputs stay on device)")
    from map_oxidize_tpu_torch.runtime import run_job

    result = run_job(config, args.workload)
    print(result.top_report(config.top_k))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
