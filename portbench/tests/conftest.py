"""Shared set-up of the harness's tests: the checkout on ``sys.path`` and
tiny sizes of each cell, for runs on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: each cell at a size a CPU test can hold, merged into its configuration
TINY = {
    "kmeans.sift1m-ivf4096": {
        "dataset": {"n": 6000, "components": 100, "block_rows": 4096},
        "job_params": {"kmeans_k": 32, "kmeans_iters": 6},
    },
    "wordcount.hibench-large.device": {
        "dataset": {"total_bytes": 600_000, "lines_per_batch": 256},
        "job_params": {"chunk_bytes": 1 << 16},
    },
}


def run_cell(cell: str, capsys, seed: int = 2**31 + 11, trace: int = 0,
             seconds: float = 0.5, overrides: dict | None = None) -> dict:
    """One harness run of ``cell`` on the CPU at its tiny size; returns
    the result line."""
    from portbench import run
    from portbench.run import merged

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], backend="cpu",
                  overrides=merged(TINY[cell], overrides))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.fixture
def cuda():
    """Skips the test on a machine without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "portbench/tests -m cuda)")
    return "cuda"
