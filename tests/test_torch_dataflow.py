"""The port's dataflow workloads (sort, join, sessionize) against the JAX
package's: the same seeded records through both packages on one device
give byte-identical output files, with the host sort, the card sort
(torch ops on CPU tensors here) and a forced demotion to disk buckets;
each run equals its NumPy oracle; the refusals, the session-gap boundary,
the CLI flags and the wall attribution match the JAX package's
contracts."""

import json

import numpy as np
import pytest
import torch

from map_oxidize_tpu.cli import build_parser as jax_build_parser
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.config import WORKLOADS, JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.workloads.join import (
    join_model,
    read_join_records,
)
from map_oxidize_tpu_torch.workloads.sessionize import sessionize_model
from map_oxidize_tpu_torch.workloads.sort import (
    RESERVED_KEY,
    read_sorted_records,
    sort_model,
)

torch.set_num_threads(2)

#: the sort placements and the forced demotion, as config overrides
PLACEMENTS = {
    "host": {},
    "device": {"collect_sort": "device"},
    "demoted": {"collect_max_rows": 1000, "shuffle_transport": "hybrid"},
}


def _kw(**kw):
    kw.setdefault("chunk_bytes", 16 * 512)
    kw.setdefault("batch_size", 1 << 12)
    return dict(backend="cpu", metrics=False, **kw)


def _records(tmp_path, name, keys, payloads=None):
    path = tmp_path / name
    np.save(path, keys if payloads is None
            else np.stack([keys, payloads], axis=1))
    return str(path)


def _both(tmp_path, workload, inp, tag, **kw):
    """Run ``workload`` through the port and (``num_shards=1``) the JAX
    package; returns ``(port_result, port_bytes, jax_bytes, port_path)``."""
    got = {}
    for pkg, cfg_cls, run in (("port", JobConfig, run_job),
                              ("jax", JaxJobConfig, jax_run_job)):
        extra = {"num_shards": 1} if pkg == "jax" else {}
        out = tmp_path / f"{tag}_{pkg}.out"
        r = run(cfg_cls(input_path=inp, output_path=str(out), **extra,
                        **_kw(**kw)), workload)
        got[pkg] = (r, out.read_bytes(), out)
    return got["port"][0], got["port"][1], got["jax"][1], got["port"][2]


def _sort_inputs(tmp_path):
    rng = np.random.default_rng(1)
    n = 5000
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[keys == RESERVED_KEY] -= np.uint64(1)
    keys[:500] = keys[0]  # a duplicate-heavy head: payload order matters
    keys[500:520] = 0
    pay = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    pay[:8] = np.uint64(1 << 63)  # top-bit payloads order unsigned
    return keys, pay, _records(tmp_path, "recs.npy", keys, pay)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_sort_matches_the_jax_package_and_the_oracle(tmp_path, placement):
    keys, pay, inp = _sort_inputs(tmp_path)
    r, port, jax, path = _both(tmp_path, "sort", inp, placement,
                               **PLACEMENTS[placement])
    assert port == jax
    gk, gp = read_sorted_records(path)
    wk, wp = sort_model(keys, pay)
    assert np.array_equal(gk, wk) and np.array_equal(gp, wp)
    assert r.n_rows == keys.shape[0] and r.n_shards == 1
    assert (r.spilled_rows == keys.shape[0]) == (placement == "demoted")
    if placement == "demoted":
        assert r.metrics["demote/events"] == 1
        assert r.metrics["spill/rows"] == keys.shape[0]


@pytest.mark.parametrize("placement", ["host", "device"])
def test_sort_keys_only_payload_is_the_row_index(tmp_path, placement):
    """A ``(n,)`` keys-only input sorts with the global row index as the
    payload: a STABLE sort, verifiable per duplicate."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 50, 3000, dtype=np.uint64)
    inp = _records(tmp_path, "keys.npy", keys)
    _r, port, jax, path = _both(tmp_path, "sort", inp, placement,
                                **PLACEMENTS[placement])
    assert port == jax
    gk, gp = read_sorted_records(path)
    wk, wp = sort_model(keys, np.arange(keys.shape[0], dtype=np.uint64))
    assert np.array_equal(gk, wk) and np.array_equal(gp, wp)


def test_sort_through_the_disk_transport_from_row_zero(tmp_path):
    keys, pay, inp = _sort_inputs(tmp_path)
    r, port, jax, _ = _both(tmp_path, "sort", inp, "disk",
                            collect_max_rows=1000, shuffle_transport="disk")
    assert port == jax
    assert r.spilled_rows == keys.shape[0]
    assert "demote/events" not in r.metrics


def test_sort_reserved_key_refused(tmp_path):
    inp = _records(tmp_path, "bad.npy",
                   np.array([1, RESERVED_KEY, 2], np.uint64))
    with pytest.raises(ValueError, match="reserved key"):
        run_job(JobConfig(input_path=inp, output_path="", **_kw()), "sort")


def _join_inputs(tmp_path, seed=5, na=3000, nb=2500, keys=500):
    rng = np.random.default_rng(seed)
    ka = rng.integers(0, keys, na, dtype=np.uint64)
    pa = rng.integers(0, 1 << 63, na, dtype=np.uint64)
    kb = rng.integers(0, keys, nb, dtype=np.uint64)
    pb = rng.integers(0, 1 << 63, nb, dtype=np.uint64)
    return (ka, pa, kb, pb, _records(tmp_path, "a.npy", ka, pa),
            _records(tmp_path, "b.npy", kb, pb))


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_join_matches_the_jax_package_and_the_oracle(tmp_path, placement):
    ka, pa, kb, pb, a, b = _join_inputs(tmp_path)
    r, port, jax, path = _both(tmp_path, "join", a, placement,
                               join_input_path=b, **PLACEMENTS[placement])
    assert port == jax
    got = read_join_records(path)
    want = join_model(ka, pa, kb, pb)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert r.n_matches == want[0].shape[0]
    assert (r.n_left, r.n_right) == (ka.shape[0], kb.shape[0])
    assert r.n_keys == np.unique(np.concatenate([ka, kb])).shape[0]
    assert r.metrics["join/matches"] == r.n_matches


def test_join_disjoint_keys_no_matches(tmp_path):
    ka = np.arange(0, 100, dtype=np.uint64)
    kb = np.arange(1000, 1100, dtype=np.uint64)
    a = _records(tmp_path, "a.npy", ka, ka)
    b = _records(tmp_path, "b.npy", kb, kb)
    r, port, jax, path = _both(tmp_path, "join", a, "disjoint",
                               join_input_path=b)
    assert port == jax == b""
    assert r.n_matches == 0
    assert read_join_records(path)[0].shape == (0,)


def test_join_payload_side_bit_refused(tmp_path):
    ka = np.array([1], np.uint64)
    a = _records(tmp_path, "a.npy", ka, np.array([1 << 63], np.uint64))
    b = _records(tmp_path, "b.npy", ka, ka)
    with pytest.raises(ValueError, match="2\\*\\*63"):
        run_job(JobConfig(input_path=a, output_path="", join_input_path=b,
                          **_kw()), "join")


def test_join_requires_the_right_corpus(tmp_path):
    a = _records(tmp_path, "a.npy", np.array([1], np.uint64))
    with pytest.raises(ValueError, match="join-input"):
        run_job(JobConfig(input_path=a, output_path="", **_kw()), "join")


def _events(tmp_path, seed=6, n=4000):
    rng = np.random.default_rng(seed)
    ek = rng.integers(0, 200, n, dtype=np.uint64)
    ts = rng.integers(0, 100_000, n, dtype=np.uint64)
    return ek, ts, _records(tmp_path, "ev.npy", ek, ts)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_sessionize_matches_the_jax_package_and_the_oracle(tmp_path,
                                                           placement):
    ek, ts, inp = _events(tmp_path)
    r, port, jax, path = _both(tmp_path, "sessionize", inp, placement,
                               session_gap=500, **PLACEMENTS[placement])
    assert port == jax
    rows = [tuple(int(x) for x in line.split("\t"))
            for line in path.read_text().splitlines()]
    mk, ms, me, mc = sessionize_model(ek, ts, 500)
    assert rows == list(zip(mk.tolist(), ms.tolist(), me.tolist(),
                            mc.tolist()))
    assert r.n_sessions == len(rows) and r.n_events == ek.shape[0]
    assert r.metrics["sessions/count"] == r.n_sessions


@pytest.mark.parametrize("placement", ["host", "device"])
def test_sessionize_gap_boundary_semantics(tmp_path, placement):
    """A gap EXACTLY equal to session_gap stays one session; one unit
    more cuts."""
    ek = np.zeros(4, np.uint64)
    ts = np.array([0, 500, 1001, 1501], np.uint64)
    inp = _records(tmp_path, "ev.npy", ek, ts)
    r, port, jax, path = _both(tmp_path, "sessionize", inp, placement,
                               session_gap=500, **PLACEMENTS[placement])
    assert port == jax
    rows = [tuple(int(x) for x in line.split("\t"))
            for line in path.read_text().splitlines()]
    assert rows == [(0, 0, 500, 2), (0, 1001, 1501, 2)]
    assert r.n_sessions == 2


@pytest.mark.parametrize("gap,valid", [(1, True), (0, False), (-5, False)])
def test_session_gap_validation(gap, valid):
    cfg = JobConfig(session_gap=gap)
    if valid:
        cfg.validate()
    else:
        with pytest.raises(ValueError, match="session_gap"):
            cfg.validate()


def test_sort_sample_validation():
    with pytest.raises(ValueError, match="sort_sample"):
        JobConfig(sort_sample=0).validate()


# --- the CLI ----------------------------------------------------------------


@pytest.mark.parametrize("flag", ["--join-input", "--session-gap",
                                  "--sort-sample", "--dist-coordinator",
                                  "--dist-processes", "--dist-process-id",
                                  "--remote-stage-dir",
                                  "--remote-stage-timeout"])
def test_cli_flag_has_the_jax_name_and_default(flag):
    def action(parser):
        (a,) = [a for a in parser._actions if flag in a.option_strings]
        return a.dest, a.default, type(a).__name__, a.type

    assert action(cli.build_parser()) == action(jax_build_parser())


def test_cli_workloads_include_the_dataflow_jobs():
    for w in ("sort", "join", "sessionize"):
        assert w in WORKLOADS
    (a,) = [a for a in cli.build_parser()._actions if a.dest == "workload"]
    assert tuple(a.choices) == WORKLOADS


def test_cli_runs_the_three_jobs_like_the_jax_cli(tmp_path, capsys):
    ka, pa, kb, pb, a, b = _join_inputs(tmp_path, na=600, nb=500, keys=90)
    ek, ts, ev = _events(tmp_path, n=900)
    runs = [("sort", a, []), ("join", a, ["--join-input", b]),
            ("sessionize", ev, ["--session-gap", "700"])]
    for workload, inp, extra in runs:
        out = tmp_path / f"{workload}.out"
        assert cli.main([workload, inp, "--backend", "cpu", "-q",
                         "--output", str(out), "--chunk-mb", "1",
                         *extra]) == 0
        line = capsys.readouterr().out.strip()
        jout = tmp_path / f"{workload}.jax"
        r = jax_run_job(JaxJobConfig(
            input_path=inp, output_path=str(jout), backend="cpu",
            num_shards=1, metrics=False, join_input_path=b,
            session_gap=700), workload)
        assert out.read_bytes() == jout.read_bytes()
        assert line == r.top_report(10)


def test_cli_refuses_a_join_without_its_right_corpus(tmp_path, capsys):
    a = _records(tmp_path, "a.npy", np.array([1, 2], np.uint64))
    assert cli.main(["join", a, "--backend", "cpu", "-q",
                     "--join-input", str(tmp_path / "missing.npy")]) == 2
    assert "join needs --join-input" in capsys.readouterr().err


# --- attribution ------------------------------------------------------------


@pytest.mark.parametrize("placement", ["host", "device", "demoted"])
def test_sort_attribution_covers_the_wall(tmp_path, placement):
    """At least 90% of a sort job's wall is attributed — the route and the
    sort land in named buckets, not ``unattributed_pct`` — and the bucket
    sum never exceeds the wall (JAX ``tests/test_dataflow.py:201``)."""
    rng = np.random.default_rng(4)
    n = 1_000_000
    inp = _records(tmp_path, "recs.npy",
                   rng.integers(0, 1 << 62, n, dtype=np.uint64),
                   rng.integers(0, 1 << 63, n, dtype=np.uint64))
    kw = dict(PLACEMENTS[placement], chunk_bytes=16 * 65536,
              batch_size=1 << 16)
    if placement == "demoted":
        kw["collect_max_rows"] = 100_000
    run_job(JobConfig(input_path=inp, output_path=str(tmp_path / "o.bin"),
                      metrics_out=str(tmp_path / "m.json"), **_kw(**kw)),
            "sort")
    att = json.loads((tmp_path / "m.json").read_text())["attrib"]
    assert att["unattributed_pct"] <= 10.0, att
    assert att["attributed_ms"] <= att["wall_ms"] + 1.0, att
    assert att["buckets"]["host_sort"]["ms"] > 0.0
    if placement == "device":
        assert att["buckets"]["device_compute"]["ms"] > 0.0
    if placement == "demoted":
        assert att["buckets"]["spill_io"]["ms"] > 0.0
