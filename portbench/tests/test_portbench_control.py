"""The comparison that decides ``correct`` fails what it must: the
control (the reference in the program's place, a step below the stated
precision or with a stated guarantee broken) and a run of the harness
with each fault that a cell can have planted in the timed path."""

from __future__ import annotations

import pytest

from portbench import calibrate, faults
from portbench.bench import Bench
from portbench.tests.conftest import CHECKOUT, TINY, run_cell

CELLS = ("kmeans.sift1m-ivf4096", "wordcount.hibench-large.device")

#: sizes at which a CPU test holds the control, and at which it reads as
#: it does at the cell's own size on the card
CONTROL_SIZE = {
    "kmeans.sift1m-ivf4096": {
        "dataset": {"n": 40000, "components": 400, "block_rows": 8192},
        "job_params": {"kmeans_k": 256, "kmeans_iters": 25},
    },
    "wordcount.hibench-large.device": TINY["wordcount.hibench-large.device"],
}


def _limits(cell: str) -> dict:
    bench = Bench(CHECKOUT)
    return bench.config(bench.cell(cell)["config"])["limits"]


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[name] > limit for name, limit in limits.items())


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, capsys):
    job = Bench(CHECKOUT).mix(Bench(CHECKOUT).cell(cell)["traffic"])["job"]
    with faults.planted(fault, job):
        res = run_cell(cell, capsys, seconds=0.1)
    assert res["correct"] is False
    assert res["failed"] > 0 or any(
        c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    limits = _limits(cell)
    assert limits
    rows = {r["run"]: r for r in calibrate.readings(
        cell, [2**31 + 21], control=True, with_faults=False, backend="cpu",
        overrides=CONTROL_SIZE[cell])}
    assert not _fails(rows["program"], limits)
    assert _fails(rows["control"], limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell, cuda):
    """On the card, at the cell's own size, on three seeds."""
    limits = _limits(cell)
    for row in calibrate.readings(cell, [71, 72, 73], control=True,
                                  with_faults=False):
        assert _fails(row, limits) == (row["run"] == "control"), row
