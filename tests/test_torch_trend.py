"""The port's ``obs trend`` (``obs/trend.py`` and its CLI) against the JAX
package's: the three ``obs trend`` cases of ``tests/test_slo.py`` and
``tests/test_attrib.py::test_trend_cli_multichip_groups`` through the
port, each also held to the JAX output on the same files, and
``trajectories`` / ``detect_steps`` / ``movers`` / ``analyze`` /
``render`` equal to the JAX functions on seeded ledgers."""

import contextlib
import io
import json

import numpy as np
import pytest

from map_oxidize_tpu.obs import ledger as jax_ledger
from map_oxidize_tpu.obs import trend as jax_trend
from map_oxidize_tpu.obs.cli import obs_main as jax_obs_main
from map_oxidize_tpu_torch.obs import ledger, trend
from map_oxidize_tpu_torch.obs.cli import obs_main


def _entry(ts, metrics, workload="wc", phases=None):
    return {"ts_unix_s": ts, "version": "1", "config_hash": "cfg",
            "workload": workload, "corpus_bytes": 1000, "n_processes": 1,
            "phases_s": dict(phases or {"map+reduce": 1.0}),
            "metrics": dict(metrics)}


def _both(argv):
    """``obs_main(argv)`` of each package: ``(rc, stdout)`` equal."""
    outs = []
    for main in (obs_main, jax_obs_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main(argv)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    return outs[0]


def test_trend_movers_rank_injected_regression_first():
    base = {"rate": 1000.0, "comms/psum/fit/bytes": 1_000_000,
            "records_in": 5000}
    entries = [_entry(i, base, phases={"map+reduce": 1.0})
               for i in range(1, 4)]
    bad = dict(base, **{"comms/psum/fit/bytes": 10_000_000})
    entries.append(_entry(4, bad, phases={"map+reduce": 1.05}))
    mv = trend.movers(entries)
    assert mv == jax_trend.movers(entries)
    assert mv[0]["name"] == "comms/psum/fit/bytes"
    assert mv[0]["rank"] == 1 and mv[0]["pct"] == pytest.approx(900.0)
    assert mv[0]["direction"] == "moved"
    steps = trend.detect_steps(trend.trajectories(entries))
    assert steps == jax_trend.detect_steps(jax_trend.trajectories(entries))
    assert steps and steps[0]["name"] == "comms/psum/fit/bytes"
    assert steps[0]["index"] == 3
    # a rate DROP is annotated as the regression direction
    slow = [_entry(i, {"rate": 1000.0}) for i in range(1, 4)]
    slow.append(_entry(4, {"rate": 500.0}))
    mv = trend.movers(slow)
    assert mv == jax_trend.movers(slow)
    assert mv[0]["name"] == "rate" and mv[0]["direction"] == "regressed"


def test_trend_cli_json_roundtrip(tmp_path, capsys):
    ldir = tmp_path / "ledger"
    base = {"rate": 100.0, "spill/rows": 10}
    for i in range(1, 4):
        ledger.append(str(ldir), _entry(i, base))
    ledger.append(str(ldir), _entry(4, dict(base, **{"spill/rows": 900})))
    rc = obs_main(["trend", "--ledger-dir", str(ldir), "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["n_entries"] == 4 and doc["workload"] == "wc"
    assert doc["movers"][0]["name"] == "spill/rows"
    assert doc["movers"][0]["direction"] == "regressed"
    # human-readable form names the mover too
    rc = obs_main(["trend", "--ledger-dir", str(ldir)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "spill/rows" in out and "movers" in out
    # too little history is a named refusal, not a crash
    rc = obs_main(["trend", "--ledger-dir", str(tmp_path / "empty")])
    assert rc == 2
    for argv in (["--json"], [], ["--all-series"]):
        _both(["trend", "--ledger-dir", str(ldir), *argv])
    _both(["trend", "--ledger-dir", str(tmp_path / "empty")])


def test_trend_bench_rounds(tmp_path, capsys):
    for i, kv in enumerate([(10.0, 1.0), (11.0, 1.1), (11.5, 0.4)], 1):
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(json.dumps(
            {"parsed": {"value": kv[0],
                        "workloads": {"distinct_256mb": kv[1]}}}))
    paths = sorted(str(p) for p in tmp_path.glob("BENCH_r*.json"))
    entries = trend.bench_rounds(paths)
    assert entries == jax_trend.bench_rounds(paths)
    assert len(entries) == 3
    mv = trend.movers(entries)
    assert mv[0]["name"] == "workloads/distinct_256mb/vs_baseline"
    assert mv[0]["direction"] == "regressed"
    rc = obs_main(["trend", "--bench",
                   str(tmp_path / "BENCH_r*.json")])
    assert rc == 0
    assert "distinct_256mb" in capsys.readouterr().out
    _both(["trend", "--bench", str(tmp_path / "BENCH_r*.json")])


def test_trend_cli_multichip_groups(tmp_path, capsys):
    for i, ok in enumerate([True, False], 1):
        (tmp_path / f"MULTICHIP_r{i:02d}.json").write_text(
            json.dumps({"n_devices": 8, "rc": 0 if ok else 1, "ok": ok,
                        "skipped": False}))
    rc = obs_main(["trend", "--bench",
                   str(tmp_path / "MULTICHIP_r*.json")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "multichip-rounds" in out
    assert "ok" in out
    _both(["trend", "--bench", str(tmp_path / "MULTICHIP_r*.json")])


def _seeded_ledger(seed, n=9, workloads=("wc", "km")):
    """``n`` entries of random walks with an injected step in a few series
    and new series appearing late, from a seeded generator."""
    rng = np.random.default_rng(seed)
    names = [f"engine/m{i}" for i in range(6)] + [
        "records_per_sec", "compile/total_compiles", "attrib/unattributed_pct",
        "plan/model_error_pct", "pipeline/overlap_ratio", "spill/rows"]
    entries = []
    for i in range(n):
        metrics = {}
        for j, name in enumerate(names):
            v = float(rng.uniform(1, 100))
            if j % 4 == 0 and i >= n - 3:
                v *= float(rng.choice([0.2, 3.0]))
            if rng.random() < 0.1:
                continue                    # a gap in the series
            metrics[name] = (int(v) if j % 3 == 1 else round(v, 3))
        if i >= n - 2:
            metrics["alerts/fired"] = int(rng.integers(0, 3))
        metrics["aborted"] = bool(i == n - 1)
        metrics["time/iterate_s"] = 9.9
        phases = {"map+reduce": round(float(rng.uniform(0.5, 2.0)), 4),
                  "write": round(float(rng.uniform(0.1, 0.3)), 4)}
        entries.append(_entry(1_700_000_000 + 3600 * i, metrics,
                              workload=workloads[i % len(workloads)],
                              phases=phases))
    return entries


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("threshold,top", [(25.0, 10), (5.0, 0), (80.0, 3)])
def test_analysis_equals_jax_on_seeded_ledgers(seed, threshold, top):
    entries = _seeded_ledger(seed)
    traj = trend.trajectories(entries)
    assert traj == jax_trend.trajectories(entries)
    for min_points in (2, 3, 5):
        assert trend.detect_steps(traj, threshold, min_points) == \
            jax_trend.detect_steps(traj, threshold, min_points)
    assert trend.movers(entries, top=top) == jax_trend.movers(entries,
                                                               top=top)
    got = trend.analyze(entries, threshold, top)
    assert got == jax_trend.analyze(entries, threshold, top)
    for show in (0, 1):
        assert trend.render(got, show) == jax_trend.render(got, show)


@pytest.mark.parametrize("seed", range(3))
def test_cli_over_a_seeded_ledger_prints_the_jax_bytes(tmp_path, seed):
    """Two workloads in one ledger written by each package's ``append``:
    the default group, ``--workload``, ``--last`` and ``--json``."""
    ldir = str(tmp_path / "ledger")
    for i, e in enumerate(_seeded_ledger(seed)):
        (ledger if i % 2 else jax_ledger).append(ldir, e)
    for argv in ([], ["--workload", "km"], ["--last", "3"],
                 ["--json", "--top", "0"], ["--threshold-pct", "10"]):
        rc, out = _both(["trend", "--ledger-dir", ldir, *argv])
        assert rc == 0 and out
