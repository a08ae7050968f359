#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 \\
        [--control] [--faults] [--out chiprun_out/calib.jsonl]

For each seed, at the cell's own size and on its card: make the dataset as
a run does, run one whole job through ``run_job`` (the path the window
drives) and read the comparison's numbers against the reference.  With
``--control``, also the control's numbers (the reference in a lower
precision, or with a guarantee broken, put in the program's place).  With
``--faults``, also the numbers of the program with each fault of
``portbench/faults.py`` planted.  One JSON line per reading, printed and
appended to ``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench import faults  # noqa: E402
from portbench.bench import Bench  # noqa: E402
from portbench.run import merged, run_one  # noqa: E402


def readings(cell_name: str, seeds, control: bool, with_faults: bool,
             backend: str = "cuda", overrides: dict | None = None):
    """Yield one dict per reading."""
    import torch

    bench = Bench(HERE.parent)
    cell = bench.cell(cell_name)
    cfg = merged(bench.config(cell["config"]), overrides)
    mix = bench.mix(cell["traffic"])
    ref = bench.reference(mix["job"])
    fault_names = faults.names(mix["job"]) if with_faults else ()
    device = "cuda" if backend == "cuda" else "cpu"
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            dataset = bench.generator(cfg["dataset"]["generator"]).generate(
                cfg["dataset"], seed, tmp, device)
            kwargs = {**cfg["job_params"], **mix["job_config"],
                      "input_path": dataset["path"], "backend": backend,
                      "checkpoint_dir": None, "metrics": False}
            t_gen = time.perf_counter() - t0
            runs = [("program", None)] + [(f, f) for f in fault_names]
            outputs = {}
            for label, fault in runs:
                with faults.planted(fault, mix["job"]):
                    rec = run_one(kwargs, mix["job"], tmp / label,
                                  cfg["output"])
                outputs[label] = (rec, [rec["output"]])
            if control:
                (tmp / "control").mkdir()
                outputs["control"] = ({"ok": True, "wall_s": 0.0},
                                      ref.control_outputs(
                                          cfg, dataset, tmp / "control",
                                          device))
            if backend == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            want = ref.expected(cfg, dataset, device)
            t_ref = time.perf_counter() - t1
            for label, (rec, paths) in outputs.items():
                t1 = time.perf_counter()
                nums = ref.judge(cfg, dataset, want, paths, device)
                yield {"cell": cell_name, "seed": seed, "run": label,
                       "ok": rec["ok"], "job_s": rec["wall_s"],
                       "judge_s": time.perf_counter() - t1,
                       "reference_s": t_ref, "generate_s": t_gen, **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for row in readings(args.workload, args.seeds, args.control,
                        args.faults):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
