"""``python -m map_oxidize_tpu_torch serve`` / ``... submit`` — the resident
job service's command-line surface: a copy of the JAX package's
``serve/cli.py`` (``serve_main`` :72, ``submit_main`` :144).

``serve`` starts the long-lived server (blocks until SIGTERM/SIGINT or a
client ``POST /shutdown``, then drains).  ``submit`` enqueues one job on
a running server and optionally waits for it; config overrides ride as
repeated ``--set key=value`` flags, coerced to the JobConfig field's
type.  Exit codes: 0 job done (or submit-and-return), 2 bad invocation,
4 the job ended rejected/failed/cancelled.
"""

from __future__ import annotations

import argparse
import logging
import sys

from map_oxidize_tpu_torch.utils.logging import configure, get_logger

_log = get_logger(__name__)


def build_serve_parser() -> argparse.ArgumentParser:
    from map_oxidize_tpu_torch.config import ServeConfig

    d = ServeConfig()
    p = argparse.ArgumentParser(
        prog="map_oxidize_tpu_torch serve",
        description="resident job server: warm multi-job serving on "
                    "the card with device-memory admission control")
    p.add_argument("--host", default=d.host)
    p.add_argument("--port", type=int, default=d.port,
                   help="HTTP port for /jobs + the telemetry plane "
                        "(0 = ephemeral, logged and written to "
                        "MOXT_OBS_PORT_FILE)")
    p.add_argument("--workers", type=int, default=d.workers,
                   help="concurrent job slots")
    p.add_argument("--max-queue", type=int, default=d.max_queue,
                   help="bounded submission queue; past it submissions "
                        "are rejected with reason queue_full")
    p.add_argument("--hbm-budget-bytes", type=int, default=d.hbm_budget_bytes,
                   help="device-memory admission budget (0 = the card's "
                        "total memory)")
    p.add_argument("--spool-dir", default=d.spool_dir,
                   help="per-job artifact spool (metrics docs, outputs, "
                        "crash bundles) and the default ledger location")
    p.add_argument("--ledger-dir", default=d.ledger_dir,
                   help="shared run ledger for every finished job "
                        "(default: <spool>/ledger; 'none' disables)")
    p.add_argument("--calib-dir", default=d.calib_dir,
                   help="persistent calibration store shared by every "
                        "job and across server restarts (default: "
                        "<spool>/calib; 'none' disables)")
    p.add_argument("--idle-evict-s", type=float, default=d.idle_evict_s,
                   help="close cached corpora idle this long (0 = never)")
    p.add_argument("--drain-timeout-s", type=float,
                   default=d.drain_timeout_s,
                   help="graceful-drain budget on shutdown")
    p.add_argument("--obs-sample-interval", type=float,
                   default=d.obs_sample_s,
                   help="server telemetry cadence (time-series ring + "
                        "device sampler)")
    p.add_argument("--slo-rules", default=d.slo_rules,
                   help="SLO rule set for the server's alert evaluator "
                        "(JSON file path or inline JSON; '' = built-in "
                        "defaults).  Serve-scoped rules watch queue-wait "
                        "p95, warm recompiles, and the HBM watermark")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def serve_main(argv: list[str]) -> int:
    args = build_serve_parser().parse_args(argv)
    configure(logging.DEBUG if args.verbose
              else logging.WARNING if args.quiet else logging.INFO)
    from map_oxidize_tpu_torch.config import ServeConfig
    from map_oxidize_tpu_torch.serve.server import (
        ResidentServer,
        install_signal_handlers,
    )

    try:
        cfg = ServeConfig(
            host=args.host, port=args.port, workers=args.workers,
            max_queue=args.max_queue,
            hbm_budget_bytes=args.hbm_budget_bytes,
            spool_dir=args.spool_dir, ledger_dir=args.ledger_dir,
            calib_dir=args.calib_dir,
            idle_evict_s=args.idle_evict_s,
            drain_timeout_s=args.drain_timeout_s,
            obs_sample_s=args.obs_sample_interval,
            slo_rules=args.slo_rules,
        ).validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    server = ResidentServer(cfg).start()
    install_signal_handlers(server)
    print(f"[serve] resident job server on {server.url} "
          f"(submit: python -m map_oxidize_tpu_torch submit --url {server.url} "
          f"<workload> <input>)")
    server.serve_forever()
    return 0


def build_submit_parser() -> argparse.ArgumentParser:
    from map_oxidize_tpu_torch.config import SERVE_WORKLOADS

    p = argparse.ArgumentParser(
        prog="map_oxidize_tpu_torch submit",
        description="submit a job to a running resident server")
    p.add_argument("--url", required=True,
                   help="the server, e.g. http://127.0.0.1:8321 (the "
                        "[serve] log line prints it)")
    p.add_argument("workload", nargs="?", default=None,
                   choices=list(SERVE_WORKLOADS),
                   help="workload to submit (omitted for --cancel / "
                        "--shutdown)")
    p.add_argument("input", nargs="?", default=None,
                   help="SERVER-local input path")
    p.add_argument("--output", default="",
                   help="server-local result path ('' = none)")
    p.add_argument("--deadline", type=float, default=None,
                   help="seconds from submission after which the job is "
                        "cancelled (cooperatively, flight-recorded)")
    p.add_argument("--est-hbm-bytes", type=int, default=0,
                   help="override the server's working-set estimate for "
                        "admission control")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="JobConfig override, repeatable (e.g. --set "
                        "batch_size=65536 --set tokenizer=unicode)")
    p.add_argument("--wait", action="store_true",
                   help="poll until the job finishes; print its record")
    p.add_argument("--timeout", type=float, default=None,
                   help="--wait bound in seconds")
    p.add_argument("--cancel", metavar="JOB_ID", default=None,
                   help="cancel this job id instead of submitting")
    p.add_argument("--shutdown", action="store_true",
                   help="request a graceful server drain instead of "
                        "submitting")
    return p


def submit_main(argv: list[str]) -> int:
    import json

    args = build_submit_parser().parse_args(argv)
    configure(logging.INFO)
    from map_oxidize_tpu_torch.serve.client import (
        ServeClient,
        ServeError,
        coerce_overrides,
    )

    client = ServeClient(args.url)
    try:
        if args.shutdown:
            print(json.dumps(client.shutdown(drain=True)))
            return 0
        if args.cancel:
            doc = client.cancel(args.cancel)
            print(json.dumps(doc, indent=1))
            return 0 if doc["state"] != "failed" else 4
        if not args.workload or not args.input:
            print("error: submit needs a workload and an input path "
                  "(unless --cancel/--shutdown)", file=sys.stderr)
            return 2
        overrides = coerce_overrides(args.set)
        doc = client.submit(args.workload, args.input, config=overrides,
                            output=args.output, deadline_s=args.deadline,
                            est_hbm_bytes=args.est_hbm_bytes)
        if args.wait and doc["state"] not in ("rejected",):
            doc = client.wait(doc["id"], timeout_s=args.timeout)
        print(json.dumps(doc, indent=1))
        return 0 if doc["state"] in ("done", "queued", "running") else 4
    except (ServeError, ValueError, OSError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
