"""``python -m map_oxidize_tpu_torch obs ...`` — observability artifact
tools.  A copy of the JAX package's ``obs/cli.py``: the same twelve
subcommands with the same flags, defaults and ``dest``s
(``build_obs_parser`` :101), and on the same documents, ledgers, stores,
bundles and archives the same stdout bytes and exit codes.  All of it is
host-side file and HTTP work: no subcommand but ``calib probe`` imports
torch or touches the card.

* ``obs xprof`` / ``obs data`` / ``obs plan`` — the launch ledger's
  program report (compiles, dispatches, achieved rates against the
  published peaks, the dispatch-gap histograms), the data-plane audit and
  the plan-vs-actual report, from a ``--metrics-out`` document or a
  ``--crash-dir`` bundle;
* ``obs where`` — the wall-clock attribution (buckets plus the
  unattributed remainder) from a document, a bundle, a live ``--url`` or
  an ``--archive``;
* ``obs merge`` — a multi-process job's ``<trace>.proc<i>`` shards into
  one Chrome trace and a skew report (:mod:`map_oxidize_tpu_torch.obs.
  merge`);
* ``obs critpath`` — the critical path from trace shards, a shard
  document, a merged Chrome trace, a document (its stored section, else
  the attribution timeline), a bundle or an ``--archive``;
* ``obs diff`` — two run-ledger entries, per-phase and per-counter, with
  ``--gate`` (exit 3 on a regression past the threshold) and
  ``--crash-dir``;
* ``obs trend`` — trajectories, step changes and movers over a ledger,
  ``BENCH_r*.json`` / ``MULTICHIP_r*.json`` rounds or a fleet archive;
* ``obs flame`` — a deep capture's host stacks joined against the
  attribution buckets;
* ``obs calib`` — ``show`` (also the bare legacy form ``obs calib
  <store>``) and ``coverage`` over a calibration store, and ``probe``
  (:mod:`map_oxidize_tpu_torch.obs.probe`), which runs the collective
  microbenchmarks on a mesh: the one subcommand that imports torch;
* ``obs fleet`` — the fleet collector (:mod:`map_oxidize_tpu_torch.obs.
  fleet`) and its HTTP plane, optionally archiving the fleet series;
* ``obs top`` — a live view of a job's, a resident server's or a fleet
  collector's ``/status`` (plain ANSI redraw), or ``--archive``'s last
  frame.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def build_obs_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="map_oxidize_tpu_torch obs",
        description="observability artifact tools (merge shards, diff "
                    "ledger runs)")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser(
        "merge", help="merge per-process trace shards into one Chrome "
                      "trace + skew report")
    m.add_argument("base", help="the run's --trace-out path: shards are "
                                "<base>.proc<i>, the merged trace is "
                                "written to <base> (or --out)")
    m.add_argument("--out", default=None,
                   help="merged Chrome trace path (default: the base path)")
    m.add_argument("--skew-out", default=None,
                   help="skew report path (default: <out>.skew.json)")
    m.add_argument("--allow-clock-skew", action="store_true",
                   help="merge even when the lockstep rounds do not "
                        "overlap after wall-clock alignment (forensics "
                        "on hosts with known-bad clocks; cross-process "
                        "ordering may be wrong)")

    cp = sub.add_parser(
        "critpath", help="causal critical-path report: which chain of "
                         "spans, feed waits, and lockstep collective "
                         "rounds across ALL processes set end-to-end "
                         "wall — per-process blame shares, slack, and "
                         "what-if estimators")
    cp.add_argument("source", nargs="?", default=None,
                    help="a run's --trace-out base (its .proc<i> shards "
                         "are used), a merged Chrome trace, a skew "
                         "report, a --metrics-out document, or a "
                         "flight-recorder crash bundle directory (omit "
                         "with --archive)")
    cp.add_argument("--archive", default=None, metavar="DIR",
                    help="a fleet series archive (obs fleet "
                         "--archive-dir): render each archived "
                         "target's critical path post-mortem — works "
                         "after every producer process exited")
    cp.add_argument("--target", default=None,
                    help="with --archive: only this target label "
                         "(host:port)")
    cp.add_argument("--allow-clock-skew", action="store_true",
                    help="compute even when shard wall clocks disagree "
                         "past the alignment bound")
    cp.add_argument("--json", action="store_true",
                    help="emit the structured critpath document")

    d = sub.add_parser(
        "diff", help="diff two ledger entries (per-phase/per-counter "
                     "deltas; --gate for a nonzero regression exit)")
    d.add_argument("--ledger-dir", required=True,
                   help="directory holding ledger.jsonl")
    d.add_argument("runs", nargs="*", default=[],
                   help="two entry indices into the (filtered) ledger, "
                        "python-style (default: -2 -1 — previous vs last)")
    d.add_argument("--workload", default=None,
                   help="filter the ledger to one workload first")
    d.add_argument("--threshold-pct", type=float, default=10.0,
                   help="regression threshold: a phase slower / throughput "
                        "lower by more than this percent flags (default 10)")
    d.add_argument("--gate", action="store_true",
                   help="exit 3 when any regression exceeds the threshold")
    d.add_argument("--force", action="store_true",
                   help="diff even when workload/config-hash/version "
                        "differ (mismatches print as warnings)")
    d.add_argument("--crash-dir", default=None,
                   help="diff a flight-recorder crash bundle (the bundle "
                        "directory, or a --crash-dir root — the newest "
                        "bundle is picked) against the most recent "
                        "comparable ledger entry")

    x = sub.add_parser(
        "xprof", help="render the program observatory report (launch "
                      "ledger, cost/MFU join, dispatch-gap histograms) "
                      "from a --metrics-out document or a crash bundle")
    x.add_argument("metrics", help="a run's --metrics-out JSON, a "
                                   "<metrics_out>.proc<i> shard document, "
                                   "or a flight-recorder --crash-dir "
                                   "bundle directory (its metrics.json "
                                   "is used; a crash-dir root resolves "
                                   "to the newest bundle)")
    x.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON instead of "
                        "the rendered tables")

    da = sub.add_parser(
        "data", help="render the data-plane audit (row-conservation "
                     "table, per-partition skew heatmap, reduction-ratio "
                     "gauges) from a --metrics-out document or a crash "
                     "bundle")
    da.add_argument("metrics", help="a run's --metrics-out JSON, a "
                                    "<metrics_out>.proc<i> shard document, "
                                    "or a flight-recorder --crash-dir "
                                    "bundle directory (its metrics.json "
                                    "is used; a crash-dir root resolves "
                                    "to the newest bundle)")
    da.add_argument("--json", action="store_true",
                    help="emit the structured audit section as JSON "
                         "instead of the rendered tables")

    tr = sub.add_parser(
        "trend", help="cross-run regression forensics: per-counter/per-"
                      "phase trajectories over N ledger entries (or "
                      "BENCH_r*.json rounds), step-change detection, and "
                      "a ranked movers report attributing a gate failure "
                      "to the counters that moved")
    tr.add_argument("--ledger-dir", default=None,
                    help="directory holding ledger.jsonl (omit when "
                         "--bench files are given)")
    tr.add_argument("--workload", default=None,
                    help="filter the ledger to one workload (default: "
                         "the workload with the most entries)")
    tr.add_argument("--last", type=int, default=0,
                    help="use only the newest N entries (0 = all)")
    tr.add_argument("--bench", nargs="*", default=[], metavar="JSON",
                    help="BENCH_r*.json round artifacts to trend instead "
                         "of (or besides) a ledger")
    tr.add_argument("--archive", default=None, metavar="DIR",
                    help="a fleet series archive (obs fleet "
                         "--archive-dir): trend the archived fleet "
                         "samples — the history that survives every "
                         "producer process exiting")
    tr.add_argument("--threshold-pct", type=float, default=25.0,
                    help="step-change detection threshold (default 25)")
    tr.add_argument("--top", type=int, default=10,
                    help="movers to rank (default 10; 0 = all)")
    tr.add_argument("--all-series", action="store_true",
                    help="print every series' trajectory, not just "
                         "phases + steps + movers")
    tr.add_argument("--json", action="store_true",
                    help="emit the structured analysis as JSON")

    w = sub.add_parser(
        "where", help="wall-clock attribution report: where every "
                      "millisecond of a job's wall went (buckets + the "
                      "unattributed remainder), from a --metrics-out "
                      "document, a crash bundle, or a live /status URL")
    w.add_argument("metrics", nargs="?", default=None,
                   help="a run's --metrics-out JSON, an obs shard, or a "
                        "flight-recorder bundle directory (omit with "
                        "--url)")
    w.add_argument("--url", default=None,
                   help="a LIVE job/server obs URL (e.g. "
                        "http://127.0.0.1:8321): render the current "
                        "/status attribution instead of a document")
    w.add_argument("--archive", default=None, metavar="DIR",
                   help="a fleet series archive: render the attribution "
                        "of the last archived per-target /status "
                        "snapshots (post-mortem — works after every "
                        "target process exited)")
    w.add_argument("--target", default=None,
                   help="with --archive: only this target label "
                        "(host:port); default: every target that "
                        "carried an attribution")
    w.add_argument("--json", action="store_true",
                   help="emit the structured attribution document")

    pl = sub.add_parser(
        "plan", help="render the plan observatory: the knob values the "
                     "planner chose before the job ran (with per-knob "
                     "provenance — curve/memo/default/pinned) and the "
                     "predicted-vs-actual wall decomposition, from a "
                     "--metrics-out document, an obs shard, or a crash "
                     "bundle")
    pl.add_argument("metrics", help="a run's --metrics-out JSON, a "
                                    "<metrics_out>.proc<i> shard document, "
                                    "or a flight-recorder --crash-dir "
                                    "bundle directory (its metrics.json "
                                    "is used; a crash-dir root resolves "
                                    "to the newest bundle)")
    pl.add_argument("--json", action="store_true",
                    help="emit the structured plan document instead of "
                         "the rendered tables")

    fl = sub.add_parser(
        "flame", help="render a deep-profile capture's host sampling "
                      "stacks (collapsed-stack format): hottest stacks "
                      "and frames, joined against the wall-attribution "
                      "buckets")
    fl.add_argument("profile", help="a capture bundle directory "
                                    "(profile_<stamp>/), a --profile-dir "
                                    "root (newest capture wins), or a "
                                    "host_stacks.collapsed file")
    fl.add_argument("--top", type=int, default=15,
                    help="stacks/frames to list (default 15)")

    cb = sub.add_parser(
        "calib", help="the calibration store tools: 'show' renders the "
                      "per-collective bandwidth curves, 'probe' fills "
                      "them with deterministic microbenchmarks (source: "
                      "probe), 'coverage' reports needs-vs-has for a "
                      "job shape (bare 'obs calib <store>' still shows)")
    cbs = cb.add_subparsers(dest="calib_cmd", required=True)
    cbw = cbs.add_parser(
        "show", help="render the store: per-collective bandwidth "
                     "curves keyed (platform, devices, topology, "
                     "collective, program, shape-bucket, source) plus "
                     "per-program dispatch/compute figures")
    cbw.add_argument("store", help="the --calib-dir directory (or its "
                                   "calib.json)")
    cbw.add_argument("--json", action="store_true",
                     help="emit the raw store document")
    cbp = cbs.add_parser(
        "probe", help="deterministic collective microbenchmarks: sweep "
                      "the framework's exchange/psum/top-k programs "
                      "across pow2 payload buckets on the current mesh "
                      "and merge the rows in with source=probe (the ONE "
                      "obs subcommand that imports torch)")
    cbp.add_argument("store", help="the --calib-dir directory to merge "
                                   "into (created if missing)")
    cbp.add_argument("--num-shards", type=int, default=8,
                     help="mesh width; on a CPU-only host this many "
                          "virtual devices are forced (default 8)")
    cbp.add_argument("--buckets", nargs="*", default=None,
                     metavar="BUCKET",
                     help="payload buckets to sweep (pow2 labels, e.g. "
                          "64KB 1MB; default 16KB..4MB)")
    cbp.add_argument("--reps", type=int, default=None,
                     help="timed repetitions per cell (default 5 — "
                          "above the chooser's min-samples floor)")
    cbp.add_argument("--backend", default="auto",
                     help="device pool to probe ('cuda'/'cpu'; default "
                          "auto: the cards when the host has one)")
    cbp.add_argument("--json", action="store_true",
                     help="emit the probe summary document")
    cbc = cbs.add_parser(
        "coverage", help="needs-vs-has over the exchange chooser's "
                         "cells for a job shape: which (collective, "
                         "bucket) curves the planner would consult, "
                         "and whether the store can answer")
    cbc.add_argument("store", help="the --calib-dir directory (or its "
                                   "calib.json)")
    cbc.add_argument("--num-shards", type=int, default=8,
                     help="job mesh width (default 8)")
    cbc.add_argument("--batch-size", type=int, default=None,
                     help="job batch size (default: JobConfig default)")
    cbc.add_argument("--collect", action="store_true",
                     help="price the pair-collect engines' exchange "
                          "shape instead of the fold engine's")
    cbc.add_argument("--min-samples", type=int, default=None,
                     help="selection floor (default: the chooser's "
                          "CALIB_MIN_SAMPLES)")
    cbc.add_argument("--platform", default=None,
                     help="identity platform (default: the store's "
                          "sole identity, else required)")
    cbc.add_argument("--topology", default=None,
                     help="identity topology, e.g. 1x8 (default: the "
                          "store's sole identity)")
    cbc.add_argument("--device-count", type=int, default=None,
                     help="identity device count (default: the store's "
                          "sole identity)")
    cbc.add_argument("--json", action="store_true",
                     help="emit the coverage report document")

    fle = sub.add_parser(
        "fleet", help="fleet observatory: poll N obs endpoints, merge "
                      "them into one fleet model, serve fleet /metrics "
                      "(per-target labels + aggregates) /status /alerts "
                      "(cross-target incidents), and archive the fleet "
                      "series to a bounded on-disk ring")
    fle.add_argument("--targets", nargs="*", default=[], metavar="URL",
                     help="explicit endpoints (http://host:port or "
                          "host:port); explicit targets never depart "
                          "the model")
    fle.add_argument("--port-file", default="",
                     help="a MOXT_OBS_PORT_FILE-format file "
                          "('<process> <port>' lines) to derive "
                          "127.0.0.1 targets from")
    fle.add_argument("--spool", nargs="*", default=[], metavar="DIR",
                     dest="spool_dirs",
                     help="resident-server spool dirs: each one's "
                          "obs_port.json names a target")
    fle.add_argument("--discover-dir", default="",
                     help="well-known port-record spool to scan for "
                          "live processes (default: $MOXT_OBS_SPOOL or "
                          "the per-user tempdir spool; 'none' disables "
                          "auto-discovery)")
    fle.add_argument("--port", type=int, default=0,
                     help="the collector's own HTTP port (0 = "
                          "ephemeral, logged and written to "
                          "MOXT_OBS_PORT_FILE as 'fleet <port>')")
    fle.add_argument("--host", default="127.0.0.1")
    fle.add_argument("--interval", type=float, default=1.0,
                     help="seconds between scrape sweeps (default 1)")
    fle.add_argument("--stale-after", type=float, default=30.0,
                     help="a target unreachable/refusing this long is "
                          "marked stale and fires the fleet staleness "
                          "alert (default 30s)")
    fle.add_argument("--archive-dir", default=None,
                     help="persistent fleet series archive "
                          "(moxt-archive-v1 ring-of-segments; read "
                          "post-mortem with obs trend/top/where "
                          "--archive)")
    fle.add_argument("--archive-segment-records", type=int, default=512,
                     help="archive ring: samples per segment file")
    fle.add_argument("--archive-max-segments", type=int, default=16,
                     help="archive ring: segments kept (oldest pruned)")
    fle.add_argument("--slo-rules", default=None,
                     help="fleet SLO rule set (JSON file path or inline "
                          "JSON; defaults: target staleness, per-target "
                          "HBM watermark fraction, scrape refusals)")
    fle.add_argument("--iterations", type=int, default=0,
                     help="stop after N scrape sweeps (0 = run until "
                          "SIGTERM/Ctrl-C — the normal daemon mode)")

    t = sub.add_parser(
        "top", help="live terminal view of a running job: poll the "
                    "--obs-port server's /status and redraw")
    t.add_argument("--url", default=None,
                   help="the job's obs server, e.g. http://127.0.0.1:8321 "
                        "(the [obs] serving log line prints it)")
    t.add_argument("--archive", default=None, metavar="DIR",
                   help="render the last archived fleet frame from an "
                        "obs fleet --archive-dir instead of polling a "
                        "live server (post-mortem view)")
    t.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls (default 2)")
    t.add_argument("--iterations", type=int, default=0,
                   help="stop after N polls (0 = until the job's server "
                        "goes away or Ctrl-C)")
    t.add_argument("--no-clear", action="store_true",
                   help="append refreshes instead of redrawing in place "
                        "(log-friendly)")
    return p


def obs_main(argv: list[str]) -> int:
    # back-compat: the pre-subcommand form `obs calib <store> [--json]`
    # keeps working — insert the implicit 'show'
    if (argv and argv[0] == "calib"
            and (len(argv) == 1
                 or argv[1] not in ("show", "probe", "coverage"))):
        argv = [argv[0], "show", *argv[1:]]
    args = build_obs_parser().parse_args(argv)
    if args.cmd == "merge":
        return _merge(args)
    if args.cmd == "xprof":
        return _xprof(args)
    if args.cmd == "data":
        return _data(args)
    if args.cmd == "top":
        return _top(args)
    if args.cmd == "trend":
        return _trend(args)
    if args.cmd == "where":
        return _where(args)
    if args.cmd == "plan":
        return _plan(args)
    if args.cmd == "flame":
        return _flame(args)
    if args.cmd == "calib":
        return _calib(args)
    if args.cmd == "fleet":
        return _fleet(args)
    if args.cmd == "critpath":
        return _critpath(args)
    return _diff(args)


def _critpath_doc_from_source(source: str, allow_clock_skew: bool):
    """Resolve an ``obs critpath`` source argument to a critpath
    document.  Accepts, in probe order: a trace base with ``.proc<i>``
    shards next to it (fresh extraction, torn shards tolerated), a single
    shard document, a merged Chrome trace (event list), a skew report
    carrying a ``critpath`` section, and a metrics document / crash
    bundle (its stored section, else the attribution timeline).  Returns
    ``(doc, title)`` or raises ``ValueError``."""
    import json

    from map_oxidize_tpu_torch.obs import critpath, merge

    shard_paths = merge.find_shards(source)
    if shard_paths:
        shards, torn = merge.read_shards_tolerant(shard_paths)
        if not shards:
            raise ValueError(
                f"no readable shards at {source}.proc* "
                f"(torn: {[t['path'] for t in torn]})")
        cov = merge.coverage_report(shards, torn)
        doc = critpath.compute_from_shards(
            shards, coverage=cov, check_clock=not allow_clock_skew)
        wl = shards[0].get("meta", {}).get("workload")
        return doc, f"critical path — {wl or '?'} ({len(shards)} shards)"
    path = resolve_metrics_path(source)
    with open(path) as f:
        loaded = json.load(f)
    if isinstance(loaded, list):
        # a merged Chrome trace: pid = process slot, already aligned
        return (critpath.compute_from_merged_events(loaded),
                "critical path — merged trace")
    if not isinstance(loaded, dict):
        raise ValueError(f"{path!r} is not a critpath source")
    if loaded.get("schema") == merge.SHARD_SCHEMA:
        meta = loaded.get("meta", {})
        return (critpath.compute_from_shards([loaded]),
                f"critical path — proc {meta.get('process')} shard only")
    stored = loaded.get("critpath")
    if stored and not stored.get("error"):
        wl = (loaded.get("meta") or {}).get("workload")
        return stored, f"critical path — {wl or '?'} (stored)"
    attrib_doc = loaded.get("attrib")
    if attrib_doc:
        wl = (loaded.get("meta") or {}).get("workload")
        return (critpath.degenerate_from_attrib(attrib_doc),
                f"critical path — {wl or '?'} (attrib timeline)")
    raise ValueError(
        f"{path!r} carries neither trace shards, a merged trace, a "
        "critpath section, nor an attrib section")


def _critpath(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs import critpath

    if args.archive:
        # post-mortem: archived per-target /status snapshots carry the
        # critpath headline and the attribution each path degenerates
        # onto — readable after every producer process exited
        from map_oxidize_tpu_torch.obs.fleet import ArchiveMismatch, SeriesArchive

        try:
            snap = SeriesArchive.latest(args.archive, "targets")
        except ArchiveMismatch as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        targets = (snap or {}).get("targets") or {}
        if args.target is not None:
            targets = {k: v for k, v in targets.items()
                       if k == args.target}
        docs = {}
        for label, st in sorted(targets.items()):
            if not isinstance(st, dict):
                continue
            try:
                docs[label] = critpath.degenerate_from_attrib(
                    st.get("attrib"))
                cp = st.get("critpath") or {}
                if cp.get("bound_by"):
                    docs[label]["bound_by"] = cp["bound_by"]
            except ValueError:
                continue
        if not docs:
            print("error: no archived target attribution"
                  + (f" for {args.target!r}" if args.target else "")
                  + f" under {args.archive!r}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(docs, indent=1, sort_keys=True))
            return 0
        for label, doc in docs.items():
            print(critpath.render(
                doc, title=f"critical path — {label} (archived)"))
        return 0
    if not args.source:
        print("error: obs critpath needs a source (trace base, merged "
              "trace, metrics document, crash bundle) or --archive",
              file=sys.stderr)
        return 2
    try:
        doc, title = _critpath_doc_from_source(args.source,
                                               args.allow_clock_skew)
    except critpath.ClockSkewError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    print(critpath.render(doc, title=title))
    return 0


def _fleet(args) -> int:
    from map_oxidize_tpu_torch.config import FleetConfig
    from map_oxidize_tpu_torch.obs.fleet import FleetCollector, FleetServer

    try:
        cfg = FleetConfig(
            targets=list(args.targets), port_file=args.port_file,
            spool_dirs=list(args.spool_dirs),
            discover_dir=args.discover_dir,
            host=args.host, port=args.port,
            poll_interval_s=args.interval,
            stale_after_s=args.stale_after,
            archive_dir=args.archive_dir,
            archive_segment_records=args.archive_segment_records,
            archive_max_segments=args.archive_max_segments,
            slo_rules=args.slo_rules,
        ).validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    collector = FleetCollector(cfg)
    server = FleetServer(collector, cfg.port, host=cfg.host).start()
    print(f"[fleet] collector on {server.url} "
          f"(/metrics /status /alerts /series; watch with "
          f"obs top --url {server.url})", flush=True)
    try:
        if args.iterations:
            for _ in range(args.iterations):
                collector.poll_once()
                import time as _time

                _time.sleep(cfg.poll_interval_s)
        else:
            collector.start()
            collector._thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        collector.stop()
        server.stop()
    return 0


def _where(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs.attrib import render

    if args.archive:
        # post-mortem: the archived per-target /status snapshots carry
        # each target's last live attribution — readable after every
        # producer process exited
        from map_oxidize_tpu_torch.obs.fleet import ArchiveMismatch, SeriesArchive

        try:
            snap = SeriesArchive.latest(args.archive, "targets")
        except ArchiveMismatch as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        targets = (snap or {}).get("targets") or {}
        if args.target is not None:
            targets = {k: v for k, v in targets.items()
                       if k == args.target}
        with_attrib = {label: st for label, st in sorted(targets.items())
                       if isinstance(st, dict) and st.get("attrib")}
        if not with_attrib:
            print("error: no archived target attribution"
                  + (f" for {args.target!r}" if args.target else "")
                  + f" under {args.archive!r}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps({label: st["attrib"]
                              for label, st in with_attrib.items()},
                             indent=1, sort_keys=True))
            return 0
        for label, st in with_attrib.items():
            wl = (st.get("meta") or {}).get("workload")
            print(render(st["attrib"],
                         title=f"where did the time go — {label} "
                               f"({wl or '?'}, archived)"))
        return 0
    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + "/status"
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                status = json.loads(resp.read())
        except (OSError, ValueError) as e:
            print(f"error: cannot reach {url}: {e}", file=sys.stderr)
            return 2
        doc = status.get("attrib")
        title = (f"where did the time go — {status.get('phase') or '?'} "
                 f"(live)")
    elif args.metrics:
        path = resolve_metrics_path(args.metrics)
        try:
            with open(path) as f:
                mdoc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: cannot read metrics document {path!r}: {e}",
                  file=sys.stderr)
            return 2
        if mdoc.get("schema"):  # an obs shard nests the metrics doc
            mdoc = mdoc.get("metrics", {})
        doc = mdoc.get("attrib")
        wl = (mdoc.get("meta") or {}).get("workload")
        title = f"where did the time go — {wl or '?'}"
    else:
        print("error: obs where needs a metrics document, --url, or "
              "--archive", file=sys.stderr)
        return 2
    if not doc:
        print("error: no attrib section (produced by a pre-attribution "
              "version?)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    print(render(doc, title=title))
    return 0


def resolve_profile_stacks(path: str) -> "tuple[str, str | None]":
    """Resolve an ``obs flame`` argument to ``(collapsed_path,
    profile_json_path)``: a collapsed file directly, a capture bundle
    directory, or a --profile-dir root (newest capture)."""
    if os.path.isfile(path):
        side = os.path.join(os.path.dirname(path), "profile.json")
        return path, side if os.path.isfile(side) else None
    direct = os.path.join(path, "host_stacks.collapsed")
    if os.path.isfile(direct):
        return direct, (os.path.join(path, "profile.json")
                        if os.path.isfile(os.path.join(path,
                                                       "profile.json"))
                        else None)
    bundles = sorted(glob.glob(os.path.join(path, "profile_*",
                                            "host_stacks.collapsed")))
    if bundles:
        newest = bundles[-1]
        side = os.path.join(os.path.dirname(newest), "profile.json")
        return newest, side if os.path.isfile(side) else None
    return path, None


def _flame(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs.profiler import flame_report

    stacks_path, profile_path = resolve_profile_stacks(args.profile)
    try:
        with open(stacks_path) as f:
            text = f.read()
    except OSError as e:
        print(f"error: cannot read collapsed stacks {stacks_path!r}: {e}",
              file=sys.stderr)
        return 2
    attrib_doc = None
    if profile_path:
        try:
            with open(profile_path) as f:
                attrib_doc = json.load(f).get("attrib")
        except (OSError, ValueError):
            pass
    print(flame_report(text, attrib_doc=attrib_doc, top=args.top))
    return 0


def _calib(args) -> int:
    if args.calib_cmd == "probe":
        return _calib_probe(args)
    if args.calib_cmd == "coverage":
        return _calib_coverage(args)
    import json

    from map_oxidize_tpu_torch.obs.calib import CalibMismatch, CalibStore, render

    try:
        store = CalibStore.load(args.store)
    except CalibMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not store.doc.get("comms") and not store.doc.get("programs"):
        print(f"error: no calibration store at {args.store!r} (runs "
              "merge into it via --calib-dir)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(store.doc, indent=1, sort_keys=True))
        return 0
    print(render(store))
    return 0


def _calib_probe(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs import probe as _probe
    from map_oxidize_tpu_torch.obs.calib import CalibMismatch

    kw = {}
    if args.buckets:
        kw["buckets"] = tuple(args.buckets)
    if args.reps:
        kw["reps"] = int(args.reps)
    try:
        summary = _probe.run_probe(args.store, num_shards=args.num_shards,
                                   backend=args.backend, **kw)
    except CalibMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
        return 0
    print(_probe.render_probe(summary))
    return 0


def _calib_coverage(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs import calib as _calib_mod

    try:
        store = _calib_mod.CalibStore.load(args.store)
    except _calib_mod.CalibMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # identity: explicit flags win; otherwise the store's sole identity
    idents = {(r["platform"], str(r["device_count"]), r["topology"])
              for r in (store.doc.get("comms") or {}).values()}
    if args.platform and args.topology and args.device_count is not None:
        ident = {"platform": args.platform,
                 "device_count": args.device_count,
                 "topology": args.topology}
    elif len(idents) == 1:
        p, dc, topo = next(iter(idents))
        ident = {"platform": p, "device_count": int(dc),
                 "topology": topo}
    else:
        print("error: store holds "
              f"{len(idents)} identities; name one with --platform "
              "--device-count --topology", file=sys.stderr)
        return 2
    if args.batch_size is None:
        from map_oxidize_tpu_torch.config import JobConfig

        batch = dataclasses_field_default(JobConfig, "batch_size")
    else:
        batch = args.batch_size
    cap, row_bytes = _calib_mod.exchange_shape(args.num_shards, batch,
                                               collect=args.collect)
    payload = (args.num_shards * args.num_shards * cap * (8 + row_bytes))
    bucket = _calib_mod.shape_bucket(payload)
    cells = [{"collective": c, "bucket": bucket}
             for c in _calib_mod.EXCHANGE_COLLECTIVE_NAMES]
    report = _calib_mod.coverage_report(
        store, ident, cells,
        min_samples=args.min_samples or _calib_mod.CALIB_MIN_SAMPLES)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0
    print(_calib_mod.render_coverage(report))
    return 0


def dataclasses_field_default(cls, name: str):
    """A dataclass field's default value (a JobConfig peek)."""
    import dataclasses

    for f in dataclasses.fields(cls):
        if f.name == name:
            return f.default
    raise AttributeError(name)


def resolve_metrics_path(path: str) -> str:
    """A metrics-document argument may be the JSON itself, a flight-
    recorder BUNDLE directory (its ``metrics.json``), or a ``--crash-dir``
    root (the newest ``crash_*`` bundle inside — the stamp prefix sorts
    chronologically)."""
    if not os.path.isdir(path):
        return path
    direct = os.path.join(path, "metrics.json")
    if os.path.isfile(direct):
        return direct
    bundles = sorted(glob.glob(os.path.join(path, "crash_*",
                                            "metrics.json")))
    if bundles:
        return bundles[-1]
    return path


def _xprof(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs.xprof import render_report

    path = resolve_metrics_path(args.metrics)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read metrics document {path!r}: {e}",
              file=sys.stderr)
        return 2
    if doc.get("schema"):  # an obs shard: the metrics doc nests inside
        doc = doc.get("metrics", {})
    report = doc.get("xprof")
    if not report:
        print("error: no xprof section in this metrics document (produced "
              "by a pre-observatory version, or the job ran no observed "
              "programs)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0
    print(render_report(report, histograms=doc.get("histograms")))
    return 0


def _data(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs.dataplane import render

    path = resolve_metrics_path(args.metrics)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read metrics document {path!r}: {e}",
              file=sys.stderr)
        return 2
    if doc.get("schema"):  # an obs shard: the metrics doc nests inside
        doc = doc.get("metrics", {})
    section = doc.get("data")
    if not section:
        print("error: no data section in this metrics document (produced "
              "by a pre-audit version, or the run disabled it with "
              "--no-data-audit)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(section, indent=1, sort_keys=True))
        return 0
    print(render(section))
    return 0


def _plan(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs.plan import render

    path = resolve_metrics_path(args.metrics)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read metrics document {path!r}: {e}",
              file=sys.stderr)
        return 2
    if doc.get("schema"):  # an obs shard: the metrics doc nests inside
        doc = doc.get("metrics", {})
    section = doc.get("plan")
    if not section:
        print("error: no plan section in this metrics document (produced "
              "by a pre-planner version, the job ran with --plan off, or "
              "this is a resident server's own bundle — each job plans "
              "itself)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(section, indent=1, sort_keys=True))
        return 0
    print(render(section))
    return 0


def _merge(args) -> int:
    from map_oxidize_tpu_torch.obs.merge import find_shards, merge_to_files

    shards = find_shards(args.base)
    if not shards:
        print(f"error: no shards found at {args.base}.proc*",
              file=sys.stderr)
        return 2
    out = args.out if args.out else args.base
    try:
        skew = merge_to_files(shards, out, args.skew_out,
                              allow_clock_skew=args.allow_clock_skew)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    skew_path = args.skew_out if args.skew_out else out + ".skew.json"
    cov = skew.get("coverage") or {}
    n_merged = len(cov.get("present_processes") or []) or len(shards)
    print(f"merged {n_merged} shards -> {out}")
    print(f"skew report -> {skew_path}")
    if cov.get("missing_processes") or cov.get("torn_shards"):
        print(f"  !! coverage gap: missing process(es) "
              f"{cov.get('missing_processes')}, torn shard(s) "
              f"{cov.get('torn_shards')} — post-mortem merge over the "
              "survivors")
    for r in skew["straggler_ranking"]:
        print(f"  proc {r['process']}: work {r['work_s']:.3f}s, "
              f"collective wait {r['collective_wait_s']:.3f}s")
    cp = skew.get("critpath") or {}
    if cp.get("bound_by"):
        print(f"  critical path: bound by {cp['bound_by']} "
              f"(obs critpath {args.base} for the full report)")
    return 0


def _diff(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs import ledger

    crash_entry = None
    workload = args.workload
    if args.crash_dir:
        path = resolve_metrics_path(args.crash_dir)
        try:
            with open(path) as f:
                crash_entry = ledger.entry_from_metrics_doc(json.load(f))
        except (OSError, ValueError) as e:
            print(f"error: cannot read crash bundle metrics {path!r}: {e}",
                  file=sys.stderr)
            return 2
        if workload is None:
            workload = crash_entry.get("workload")
    entries = ledger.read(args.ledger_dir, workload)
    if not entries:
        print(f"error: no ledger entries under {args.ledger_dir}"
              + (f" for workload {workload!r}" if workload
                 else ""), file=sys.stderr)
        return 2
    if crash_entry is not None:
        # before = a chosen (default: last) ledger entry, after = the
        # crashed run's partial metrics — "what changed before it died"
        specs = args.runs if args.runs else ["-1"]
        if len(specs) != 1:
            print("error: --crash-dir takes at most one ledger index "
                  "(the entry to compare the bundle against)",
                  file=sys.stderr)
            return 2
        try:
            a = entries[int(specs[0])]
        except (ValueError, IndexError):
            print(f"error: bad ledger index {specs[0]!r} "
                  f"({len(entries)} entries)", file=sys.stderr)
            return 2
        b = crash_entry
    else:
        specs = args.runs if args.runs else ["-2", "-1"]
        if len(specs) != 2:
            print("error: diff takes exactly two entry indices",
                  file=sys.stderr)
            return 2
        try:
            idx = [int(s) for s in specs]
        except ValueError:
            print(f"error: run specs must be integer indices, got {specs}",
                  file=sys.stderr)
            return 2
        try:
            a, b = entries[idx[0]], entries[idx[1]]
        except IndexError:
            print(f"error: ledger has {len(entries)} entries; indices "
                  f"{idx} out of range", file=sys.stderr)
            return 2
    try:
        diff = ledger.diff_entries(a, b, args.threshold_pct, args.force)
    except ledger.LedgerMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if crash_entry is not None and crash_entry.get("aborted"):
        print("NOTE: comparing against a crash bundle (partial metrics "
              "as of the abort); phase times and totals read low")
    print(ledger.format_diff(a, b, diff))
    if args.gate and diff["regressions"]:
        return 3
    return 0


# --- obs trend -------------------------------------------------------------


def _trend(args) -> int:
    import json

    from map_oxidize_tpu_torch.obs import ledger, trend

    groups: list[tuple[str, list]] = []
    if args.archive:
        from map_oxidize_tpu_torch.obs.fleet import ArchiveMismatch

        try:
            entries = trend.archive_entries(args.archive, last=args.last)
        except (ArchiveMismatch, OSError) as e:
            print(f"error: cannot read fleet archive: {e}",
                  file=sys.stderr)
            return 2
        if len(entries) >= 2:
            groups.append(("fleet-archive", entries))
        else:
            print(f"(fleet archive: only {len(entries)} sample — need "
                  ">= 2 to trend)")
    if args.bench:
        paths: list[str] = []
        for spec in args.bench:
            hits = sorted(glob.glob(spec))
            paths += hits if hits else [spec]
        try:
            entries = trend.bench_rounds(paths)
        except (OSError, ValueError) as e:
            print(f"error: cannot read bench round: {e}", file=sys.stderr)
            return 2
        # BENCH and MULTICHIP rounds load side by side but trend as
        # separate groups — a scoreboard ratio and a dryrun pass flag
        # share no axis
        by_kind: dict[str, list] = {}
        for e in entries:
            by_kind.setdefault(e["workload"], []).append(e)
        ok = False
        for kind, es in sorted(by_kind.items()):
            if len(es) >= 2:
                groups.append((kind, es))
                ok = True
            else:
                print(f"({kind}: only {len(es)} round — need >= 2 to "
                      "trend)")
        if not ok:
            print(f"error: need >= 2 rounds of a kind, got "
                  f"{ {k: len(v) for k, v in by_kind.items()} }",
                  file=sys.stderr)
            return 2
    if args.ledger_dir:
        entries = ledger.read(args.ledger_dir, args.workload)
        if not entries and not groups:
            print(f"error: no ledger entries under {args.ledger_dir}"
                  + (f" for workload {args.workload!r}" if args.workload
                     else ""), file=sys.stderr)
            return 2
        by_wl: dict[str, list] = {}
        for e in entries:
            by_wl.setdefault(e.get("workload") or "?", []).append(e)
        if args.workload is None and len(by_wl) > 1:
            # default to the richest history; name the rest so the
            # operator knows what to ask for
            names = sorted(by_wl, key=lambda w: -len(by_wl[w]))
            print(f"(ledger holds {len(by_wl)} workloads; trending "
                  f"{names[0]!r} — pass --workload for "
                  f"{', '.join(repr(n) for n in names[1:6])})")
            by_wl = {names[0]: by_wl[names[0]]}
        for wl, es in sorted(by_wl.items()):
            if args.last and args.last > 1:
                es = es[-args.last:]
            if len(es) >= 2:
                groups.append((wl, es))
            else:
                print(f"(workload {wl!r}: only {len(es)} entry — need "
                      ">= 2 to trend)")
    if not groups and not args.bench and not args.ledger_dir \
            and not args.archive:
        print("error: obs trend needs --ledger-dir, --bench files, "
              "and/or --archive", file=sys.stderr)
        return 2
    if not groups:
        return 2
    analyses = [trend.analyze(es, args.threshold_pct, args.top)
                for _wl, es in groups]
    if args.json:
        print(json.dumps(analyses if len(analyses) > 1 else analyses[0],
                         indent=1, sort_keys=True))
        return 0
    for a in analyses:
        print(trend.render(a, show_series=1 if args.all_series else 0))
    return 0


# --- obs top ---------------------------------------------------------------


from map_oxidize_tpu_torch.obs.metrics import format_bytes as _fmt_bytes


def render_status(doc: dict) -> str:
    """One ``obs top`` frame from a ``/status`` document.  Pure, so tests
    pin the rendering without a server."""
    meta = doc.get("meta", {})
    head = (f"moxt obs top — {meta.get('workload') or '?'} "
            f"v{meta.get('version', '?')} cfg {meta.get('config_hash')}")
    if doc.get("n_processes", 1) > 1:
        head += f"  [proc {doc.get('process')}/{doc.get('n_processes')}]"
    lines = [head]
    line = (f"phase={doc.get('phase') or '?'} "
            f"elapsed={doc.get('elapsed_s', 0):.1f}s")
    prog = doc.get("progress") or {}
    if prog:
        line += (f" rows={prog.get('rows', 0):,} "
                 f"({prog.get('rows_per_sec', 0):,.0f} rows/s)")
        if prog.get("fraction") is not None:
            line += f" {100 * prog['fraction']:.1f}%"
        if prog.get("eta_s") is not None:
            line += f" eta={prog['eta_s']:.0f}s"
        if prog.get("hbm_bytes") is not None:
            line += f" hbm={_fmt_bytes(prog['hbm_bytes'])}"
    lines.append(line)
    stalls = (doc.get("counters") or {}).get("heartbeat/stalls")
    if stalls:
        lines.append(f"!! {stalls:g} stall episode(s)")
    xprof = doc.get("xprof") or {}
    progs = xprof.get("programs") or {}
    if progs:
        lines.append(
            f"programs ({xprof.get('total_compiles', 0)} compiles, "
            f"{xprof.get('total_dispatches', 0)} dispatches):")
        lines.append(f"  {'program':<28} {'n':>3} {'disp':>6} {'MFU%':>6} "
                     f" bound")
        ranked = sorted(progs.items(),
                        key=lambda kv: -kv[1].get("dispatches", 0))
        for name, r in ranked[:8]:
            lines.append(
                f"  {name:<28} {r.get('compiles', 0):>3} "
                f"{r.get('dispatches', 0):>6} "
                f"{r.get('mfu_pct', '-'):>6}  {r.get('bound', '-')}")
    comms = doc.get("comms") or []
    if comms:
        lines.append("comms:")
        lines.append(f"  {'collective':<11} {'program':<24} {'shape':<12} "
                     f"{'calls':>6} {'bytes':>9} {'p50 ms':>7}")
        for c in comms[:8]:
            lat = c.get("latency_ms") or {}
            p50 = lat.get("p50")
            lines.append(
                f"  {c['collective']:<11} {c['program']:<24} "
                f"{c['shape']:<12} {c['count']:>6} "
                f"{_fmt_bytes(c['bytes']):>9} "
                f"{p50 if p50 is not None else '-':>7}")
    at = doc.get("attrib")
    if at:
        from map_oxidize_tpu_torch.obs.attrib import render as render_attrib

        lines.append(render_attrib(at, title="where"))
    cp = doc.get("critpath")
    if cp and cp.get("bound_by"):
        # the causal one-liner: what bounded the job, end to end
        line = f"bound by: {cp['bound_by']}"
        slack_ms = cp.get("top_process_slack_ms")
        if isinstance(slack_ms, (int, float)) and slack_ms > 0:
            line += f"  (top process slack {slack_ms / 1e3:.2f}s)"
        cw = cp.get("collective_wait_share_pct")
        if isinstance(cw, (int, float)) and cw > 0:
            line += f"  collective-wait {cw:.1f}% of path"
        lines.append(line)
    agg = doc.get("aggregate")
    if agg:
        lines.append(
            f"aggregate (x{agg.get('n_processes')}): "
            f"~{agg.get('est_rows_per_sec', 0):,.0f} rows/s global, "
            f"collective wait {agg.get('collective_wait_s', 0):.2f}s "
            f"({100 * agg.get('collective_wait_frac', 0):.1f}% of wall)")
    spans = doc.get("open_spans")
    if spans:
        lines.append("open spans: " + "; ".join(spans[:4]))
    return "\n".join(lines)


def render_alerts(doc: dict) -> str:
    """The SLO plane's ``/alerts`` document as an ``obs top`` panel:
    firing alerts (rule, series, observed value) plus the recently
    resolved tail.  Pure, so tests pin the rendering without a server."""
    counts = doc.get("counts") or {}
    firing = doc.get("firing") or []
    resolved = doc.get("resolved") or []
    head = (f"alerts: {len(firing)} firing "
            f"(lifetime {counts.get('fired', 0)} fired / "
            f"{counts.get('resolved', 0)} resolved)")
    lines = [head]
    def _g(v):
        return f"{v:g}" if isinstance(v, (int, float)) else "?"

    for a in firing[:8]:
        lines.append(
            f"  !! {a.get('severity', '?').upper():<8} {a['rule']}: "
            f"{a['series']}={_g(a.get('value'))} "
            f"({a.get('op', '?')} {_g(a.get('threshold'))})")
    for e in resolved[-4:]:
        lines.append(
            f"  ok resolved {e['rule']}: {e['series']} "
            f"(was {_g(e.get('value'))})")
    return "\n".join(lines)


def render_jobs(doc: dict) -> str:
    """The resident server's ``/jobs`` table as an ``obs top`` section.
    Pure, so tests pin the rendering without a server."""
    counts = doc.get("counts") or {}
    q = doc.get("queue") or {}
    summary = ", ".join(f"{n} {s}" for s, n in sorted(counts.items()))
    head = (f"jobs ({summary or 'none yet'};"
            f" queue {q.get('depth', 0)}/{q.get('max', '?')}")
    hbm = doc.get("hbm") or {}
    if hbm.get("budget_bytes"):
        in_use = max(hbm.get("reserved_bytes", 0),
                     hbm.get("measured_live_bytes", 0))
        head += (f", hbm {_fmt_bytes(in_use)}"
                 f"/{_fmt_bytes(hbm['budget_bytes'])}")
    if doc.get("draining"):
        head += ", DRAINING"
    lines = [head + "):"]
    lines.append(f"  {'id':<10} {'state':<9} {'workload':<13} {'phase':<12} "
                 f"{'rows/s':>9} {'compiles':>8}  reason")
    for r in (doc.get("jobs") or [])[:12]:
        rate = r.get("rows_per_sec")
        if rate is None and r.get("records_in") and r.get("duration_s"):
            rate = round(r["records_in"] / max(r["duration_s"], 1e-9), 1)
        compiles = r.get("compiles")
        lines.append(
            f"  {r['id']:<10} {r['state']:<9} {r['workload']:<13} "
            f"{(r.get('phase') or '-'):<12} "
            f"{(f'{rate:,.0f}' if rate is not None else '-'):>9} "
            f"{(compiles if compiles is not None else '-'):>8}  "
            f"{r.get('reason') or '-'}")
    return "\n".join(lines)


def render_fleet(doc: dict) -> str:
    """A ``moxt-fleet-status-v1`` document as an ``obs top`` frame: the
    per-target table (state, phase, rows/sec, HBM, queue, firing alerts,
    staleness) plus the fleet aggregates.  Pure, so tests pin the
    rendering without a collector."""
    counts = doc.get("counts") or {}
    agg = doc.get("aggregates") or {}
    head = (f"moxt obs fleet — {counts.get('targets', 0)} targets "
            f"({counts.get('up', 0)} up, {counts.get('stale', 0)} stale"
            + (f", {counts['departed']} departed"
               if counts.get("departed") else "")
            + f")  uptime={doc.get('uptime_s', 0):.0f}s")
    lines = [head]
    lines.append(
        f"fleet: {agg.get('rows_per_sec', 0):,.0f} rows/s, "
        f"hbm max {_fmt_bytes(int(agg.get('hbm_max_bytes', 0) or 0))}, "
        f"queue {agg.get('queue_depth', 0):g}, "
        f"{agg.get('jobs_running', 0):g} running, "
        f"{agg.get('target_alerts_firing', 0):g} target alerts firing")
    targets = doc.get("targets") or []
    if targets:
        lines.append(
            f"  {'target':<21} {'state':<8} {'kind':<6} {'phase':<14} "
            f"{'rows/s':>9} {'hbm':>9} {'queue':>5} {'alerts':>6} "
            f"{'stale s':>7}")
        for t in targets[:16]:
            stale_s = t.get("staleness_s") or 0
            lines.append(
                f"  {t['target']:<21} {t['state']:<8} "
                f"{t.get('kind', '?'):<6} "
                f"{(t.get('phase') or '-'):<14} "
                f"{t.get('rows_per_sec', 0):>9,.0f} "
                f"{_fmt_bytes(int(t.get('hbm_bytes') or 0)):>9} "
                f"{t.get('queue_depth', 0):>5g} "
                f"{t.get('alerts_firing', 0):>6g} "
                f"{(f'{stale_s:.0f}' if stale_s else '-'):>7}")
    arch = doc.get("archive")
    if arch:
        lines.append(f"archive: {arch['dir']} "
                     f"({arch['segments']} segments, cap "
                     f"{arch['max_records']} samples)")
    return "\n".join(lines)


def render_fleet_alerts(doc: dict) -> str:
    """A ``moxt-fleet-alerts-v1`` document as an ``obs top`` panel: the
    correlated incidents (one row per rule, naming every target) plus
    the collector's own firing set."""
    incidents = doc.get("incidents") or []
    fleet = doc.get("fleet") or {}
    counts = fleet.get("counts") or {}
    lines = [f"fleet alerts: {len([i for i in incidents if i['active']])}"
             f" active incidents (collector lifetime "
             f"{counts.get('fired', 0)} fired / "
             f"{counts.get('resolved', 0)} resolved)"]
    for inc in incidents[:8]:
        mark = "!!" if inc.get("active") else "ok"
        lines.append(
            f"  {mark} {inc.get('severity', '?').upper():<8} "
            f"{inc['rule']}: {inc['k']} target(s) — "
            f"{', '.join(inc['targets'][:6])}"
            + ("" if inc.get("active") else " (resolved)"))
    return "\n".join(lines)


def _top_archive(args) -> int:
    """``obs top --archive``: the last archived fleet frame, rendered
    once — the post-mortem view after every process exited."""
    from map_oxidize_tpu_torch.obs.fleet import ArchiveMismatch, SeriesArchive

    try:
        status = SeriesArchive.latest(args.archive, "status")
        alerts = SeriesArchive.latest(args.archive, "alerts")
    except ArchiveMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not status:
        print(f"error: no archived fleet status under {args.archive!r}",
              file=sys.stderr)
        return 2
    frame = render_fleet(status)
    if alerts and alerts.get("schema") == "moxt-fleet-alerts-v1":
        frame += "\n" + render_fleet_alerts(alerts)
    print(frame)
    print(f"(archived frame as of t={status.get('t_unix_s')})")
    return 0


def _top(args) -> int:
    import json
    import time
    import urllib.error
    import urllib.request

    if args.archive:
        return _top_archive(args)
    if not args.url:
        print("error: obs top needs --url (live) or --archive "
              "(post-mortem)", file=sys.stderr)
        return 2
    base = args.url.rstrip("/")
    url = base + "/status"
    polls = 0
    seen_one = False
    try:
        while True:
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    doc = json.loads(resp.read())
            except (urllib.error.URLError, OSError, ValueError) as e:
                if seen_one:
                    # the server going away after healthy polls means
                    # the job finished — a clean exit, not an error
                    print("job's obs server went away (job finished?)")
                    return 0
                print(f"error: cannot reach {url}: {e}", file=sys.stderr)
                return 2
            seen_one = True
            fleet_schema = doc.get("schema") == "moxt-fleet-status-v1"
            frame = render_fleet(doc) if fleet_schema \
                else render_status(doc)
            # the SLO plane's panel rides beside the job view (servers
            # without an evaluator 404 here — skip silently); a fleet
            # collector serves the correlated-incident form instead
            try:
                with urllib.request.urlopen(base + "/alerts",
                                            timeout=5) as resp:
                    alerts_doc = json.loads(resp.read())
                if alerts_doc.get("schema") == "moxt-fleet-alerts-v1":
                    frame += "\n" + render_fleet_alerts(alerts_doc)
                elif alerts_doc.get("schema") == "moxt-alerts-v1":
                    frame += "\n" + render_alerts(alerts_doc)
            except (urllib.error.URLError, OSError, ValueError):
                pass
            # a resident job server carries /jobs too: render the table
            # (plain per-job telemetry servers 404 here — skip silently)
            if not fleet_schema:
                try:
                    with urllib.request.urlopen(base + "/jobs",
                                                timeout=5) as resp:
                        jobs_doc = json.loads(resp.read())
                    if jobs_doc.get("schema") == "moxt-jobs-v1":
                        frame += "\n" + render_jobs(jobs_doc)
                except (urllib.error.URLError, OSError, ValueError):
                    pass
            if args.no_clear:
                print(frame)
                print("-" * 40)
            else:
                # ANSI clear + home: curses-free redraw-in-place
                sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                sys.stdout.flush()
            polls += 1
            if args.iterations and polls >= args.iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        # Ctrl-C anywhere in the poll cycle (a blocked fetch included)
        # is "stop watching", never a traceback
        return 0
