#!/usr/bin/env python3
"""Run one cell of the benchmark of ``map_oxidize_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The run:

1. makes the cell's dataset from the seed, on the card, into a new
   directory under ``$TMPDIR`` (removed at the end);
2. warms up with the mix's ``warmup_jobs`` whole jobs on the same input,
   or on its first ``warmup_prefix_bytes`` (whole lines: the same chunk
   shapes in less time);
3. runs whole jobs back to back through ``map_oxidize_tpu_torch.runtime.
   run_job`` until ``--seconds`` have passed; the job in flight then
   finishes inside the window.  Each job reads the input file, runs its
   route and writes its output into a directory of its own;
4. after the window, checks every job's written output against the plain
   reference in ``reference/<job>.py``;
5. prints the check lines last on standard error and, as the last line of
   standard output, one JSON object: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer metrics, read under ``torch.profiler``),
   ``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.

``setup_s`` runs from the start of the process to the start of the
window.  Exit codes: 0 with a result line; 2 for bad arguments; 3 without
the cards the cell asks for; 4 when a JAX module is loaded; anything else
is a failure of the harness.
"""

from __future__ import annotations

import time

_T_MODULE = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: kernel caches at fixed paths inside the checkout, so that only the first
#: run in a checkout builds (the port's own libraries go to its fixed
#: ``map_oxidize_tpu_torch/_build/``)
CACHE = CHECKOUT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

from portbench.bench import Bench  # noqa: E402
from portbench.trace import Trace  # noqa: E402

#: top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "map_oxidize_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux: its start in
    clock ticks since boot against ``/proc/uptime``), else the time this
    module began."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_MODULE


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for key, val in (over or {}).items():
        out[key] = (merged(out[key], val) if isinstance(val, dict)
                    and isinstance(out.get(key), dict) else val)
    return out


class Run:
    """What a finished run leaves for the metric readers."""

    def __init__(self, cell, cfg, mix, dataset, device_name):
        self.cell, self.config, self.mix = cell, cfg, mix
        self.dataset = dataset
        self.device_name = device_name
        #: per job of the window: wall_s, ok, metrics, output
        self.jobs: list[dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace: Trace | None = None

    @property
    def done(self) -> list[dict]:
        return [j for j in self.jobs if j["ok"]]


def run_one(kwargs: dict, job: str, out_dir: Path, output: str,
            on_obs=None) -> dict:
    """One whole job through ``run_job`` into ``out_dir``: its output, and
    for a job with a top-k its ``top_k.txt`` beside it (what the CLI
    prints)."""
    from map_oxidize_tpu_torch.config import JobConfig
    from map_oxidize_tpu_torch.runtime import run_job

    out_dir.mkdir(parents=True)
    path = out_dir / output
    t0 = time.perf_counter()
    try:
        res = run_job(JobConfig(**kwargs, output_path=str(path)), job,
                      on_obs=on_obs)
        top = getattr(res, "top", None)
        if top is not None:
            (out_dir / "top_k.txt").write_bytes(b"".join(
                w + b" " + str(int(c)).encode() + b"\n" for w, c in top))
    except Exception:  # a failed job is counted, and the run goes on
        traceback.print_exc()
        return {"wall_s": time.perf_counter() - t0, "ok": False,
                "metrics": {}, "output": path, "trace": None}
    return {"wall_s": time.perf_counter() - t0, "ok": True,
            "metrics": res.metrics, "output": path,
            "trace": getattr(res, "trace", None)}


def warmup_input(path: str, prefix_bytes: int, tmp: Path) -> str:
    """The warm-up jobs' input: the whole input, or with ``prefix_bytes``
    a text file of its first lines up to that many bytes (the same chunk
    shapes as the whole, in less time)."""
    if not prefix_bytes:
        return path
    with open(path, "rb") as f:
        head = f.read(prefix_bytes)
    out = tmp / "warmup_input.txt"
    out.write_bytes(head[:head.rfind(b"\n") + 1])
    return str(out)


def main(argv=None, *, backend: str = "cuda",
         overrides: dict | None = None) -> int:
    """One run.  ``backend`` 'cpu' and ``overrides`` (merged into the
    configuration) are for the harness's own tests: the command line has
    neither."""
    t_start = process_start()
    args = parse(argv)
    bench = Bench(CHECKOUT)
    cell = bench.cell(args.workload)
    cfg = merged(bench.config(cell["config"]), overrides)
    mix = bench.mix(cell["traffic"])
    if mix.get("arrival") != "closed_loop" or mix.get("clients") != 1:
        raise ValueError(f"{cell['traffic']}: this driver runs one client in "
                         "a closed loop (arrival 'closed_loop', clients 1)")

    import torch

    # the system under test: without it, fail before any set-up
    import map_oxidize_tpu_torch.runtime  # noqa: F401

    if backend == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
                  "device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device, device_name = "cuda", torch.cuda.get_device_name(0)
    else:
        device, device_name = "cpu", "cpu"
    run = Run(cell, cfg, mix, None, device_name)
    job = mix["job"]
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        run.dataset = bench.generator(cfg["dataset"]["generator"]).generate(
            cfg["dataset"], args.seed, tmp, device)
        kwargs = {**cfg["job_params"], **mix["job_config"],
                  "input_path": run.dataset["path"], "backend": backend,
                  "checkpoint_dir": None, "metrics": False}
        warm_kwargs = dict(kwargs, input_path=warmup_input(
            run.dataset["path"], int(mix.get("warmup_prefix_bytes", 0)),
            tmp))
        for i in range(int(mix["warmup_jobs"])):
            warm = run_one(warm_kwargs, job, tmp / f"warmup{i}",
                           cfg["output"])
            if not warm["ok"]:
                print("portbench: the warm-up job failed", file=sys.stderr)
        if backend == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        measure(run, args, kwargs, job, tmp, t_start)
        peak = (torch.cuda.max_memory_allocated() if backend == "cuda"
                else 0)
        # the reference runs on a card the program has let go of
        gc.collect()
        if backend == "cuda":
            torch.cuda.empty_cache()
        ref = bench.reference(job)
        numbers = ref.check(cfg, run.dataset,
                            [j["output"] for j in run.jobs], device)
        metrics = read_metrics(bench, run, args.trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    limits = cfg.get("limits", {})
    # a number the reference did not give reads null, and fails
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    failed = len(run.jobs) - len(run.done)
    correct = (bool(run.jobs) and not failed and bool(checks)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the process holds {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    device_info = {"platform": "gpu" if backend == "cuda" else "cpu",
                   "kind": device_name, "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(run.jobs),
              "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    print("portbench: setup_s %r, window_s %r, job walls %s" % (
        run.setup_s, run.window_s,
        [round(j["wall_s"], 4) for j in run.jobs]), file=sys.stderr)
    for name, v in numbers.items():
        if name not in limits:
            print(f"portbench: reading {name} {v!r} (no limit)",
                  file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def measure(run: Run, args, kwargs: dict, job: str, tmp: Path,
            t_start: float) -> None:
    """The window: whole jobs back to back until ``args.seconds`` have
    passed, under ``torch.profiler`` with ``--trace 1``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = kwargs["backend"] == "cuda"
    prof = None
    stack = contextlib.ExitStack()
    port_spans: dict[int, tuple[float, list]] = {}
    if args.trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = stack.enter_context(profile(activities=acts))
        kwargs = {**kwargs, "trace_out": "-"}

    def span(name: str):
        return (record_function(name) if prof is not None
                else contextlib.nullcontext())

    with stack:
        run.setup_s = time.time() - t_start
        t0 = time.perf_counter()
        with span("portbench/window"):
            while True:
                i = len(run.jobs)
                anchor: dict = {}
                with span("portbench/job"):
                    t_job = time.time()
                    rec = run_one(
                        kwargs, job, tmp / f"job{i:04d}", run.config["output"],
                        on_obs=(lambda obs: anchor.setdefault(
                            "wall", obs.tracer.wall_start))
                        if prof is not None else None)
                if prof is not None and rec["trace"] and "wall" in anchor:
                    port_spans[i] = ((anchor["wall"] - t_job) * 1e6,
                                     rec["trace"])
                rec["trace"] = None
                run.jobs.append(rec)
                if time.perf_counter() - t0 >= args.seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
    if prof is not None:
        run.trace = Trace.from_profile(prof, port_spans)


def read_metrics(bench: Bench, run: Run, trace: int) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics; a reader that finds nothing to read leaves its metric out."""
    out = {}
    if not trace:
        for m in bench.end_to_end(run.cell["name"]):
            v = (run.setup_s if m["name"] == "setup_s"
                 else bench.reader("end_to_end", m["name"])(run))
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in bench.per_layer(run.cell["name"]):
        v = bench.reader("layer_metrics", m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
