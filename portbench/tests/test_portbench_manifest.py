"""The manifest keeps to the benchmark's contract, and the harness finds
every file of a cell by name, also for a cell added later."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench.bench import NAME, UNIT, Bench

CHECKOUT = Path(__file__).resolve().parents[2]
HOME = CHECKOUT / "portbench"
MANIFEST = json.loads((CHECKOUT / "BENCHMARK.json").read_text())

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == TOP
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_exactly_their_keys(section, keys):
    for entry in MANIFEST[section]:
        assert set(entry) == keys, entry["name"]
        for text in ("why", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200
                assert "\n" not in entry[text] and "\t" not in entry[text]


def test_metric_entries():
    names = set()
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_names_and_units_use_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            names.append(entry["name"])
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key]), entry[key]
            for key in entry.get("reduced", []):
                assert NAME.match(key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            if "better" in entry:
                assert entry["better"] in ("lower", "higher")
    for name in names:
        assert NAME.match(name), name
    for section in ("configs", "workloads"):
        sec = [e["name"] for e in MANIFEST[section]]
        assert len(sec) == len(set(sec))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_cells_are_what_the_benchmark_promises():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert set(cells) == {"kmeans.sift1m-ivf4096",
                          "wordcount.hibench-large.device"}
    assert all(w["chips"] == 1 for w in cells.values())
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    bench = Bench(CHECKOUT)
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    for c in MANIFEST["configs"]:
        if c["name"] == w["config"]:
            assert c["file"].startswith("portbench/")
            assert c["reduced"] == cfg["reduced"]
            assert c["source"] == cfg["source"]
    mix = bench.mix(w["traffic"])
    assert callable(bench.generator(cfg["dataset"]["generator"]).generate)
    ref = bench.reference(mix["job"])
    assert callable(ref.check) and callable(ref.control_outputs)
    e2e = bench.end_to_end(cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    for m in e2e:
        if m["name"] != "setup_s":
            assert callable(bench.reader("end_to_end", m["name"]))
    layer = bench.per_layer(cell)
    assert layer
    for m in layer:
        assert callable(bench.reader("layer_metrics", m["name"]))


def _add_cell(root: Path) -> None:
    """A new configuration, traffic mix, end-to-end and per-layer metric,
    added as new files and manifest entries only."""
    home = root / "portbench"
    cfg = json.loads((home / "configs" / "sift1m-ivf4096.json").read_text())
    cfg["name"] = "tiny-points"
    cfg["dataset"] = {**cfg["dataset"], "n": 3000, "components": 50}
    cfg["job_params"] = {**cfg["job_params"], "kmeans_k": 16,
                         "kmeans_iters": 3}
    (home / "configs" / "tiny-points.json").write_text(json.dumps(cfg))
    (home / "mixes" / "kmeans.twice.json").write_text(json.dumps(
        {"job": "kmeans", "arrival": "closed_loop", "clients": 1,
         "warmup_jobs": 2, "job_config": {"mapper": "device"}}))
    (home / "end_to_end" / "jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    (home / "layer_metrics" / "jobs.first_wall_s.py").write_text(
        "def read(run):\n    return run.jobs[0]['wall_s'] if run.jobs "
        "else None\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-points", "source": "a test",
                           "file": "portbench/configs/tiny-points.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "kmeans.tiny", "config": "tiny-points",
                             "traffic": "kmeans.twice", "chips": 1,
                             "why": "a test"})
    man["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["kmeans.tiny"]})
    man["per_layer"].append({"name": "jobs.first_wall_s", "unit": "s",
                             "better": "lower", "source": "host_clock",
                             "layer": "driver", "moves": "jobs_done"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def _digest(home: Path) -> dict:
    return {p.relative_to(home): p.read_bytes() for p in home.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_an_added_cell_needs_no_edit(tmp_path):
    shutil.copytree(HOME, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    _add_cell(tmp_path)
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    bench = Bench(tmp_path, home=tmp_path / "portbench")
    w = bench.cell("kmeans.tiny")
    assert bench.config(w["config"])["job_params"]["kmeans_k"] == 16
    assert bench.mix(w["traffic"])["warmup_jobs"] == 2
    assert [m["name"] for m in bench.end_to_end("kmeans.tiny")] == [
        "setup_s", "jobs_done"]
    assert [m["name"] for m in bench.per_layer("kmeans.tiny")] == [
        "jobs.first_wall_s"]
    assert bench.reader("end_to_end", "jobs_done")(
        type("R", (), {"done": [1, 2]})()) == 2.0
    # the new metrics reach no existing cell
    assert "jobs_done" not in {
        m["name"] for m in bench.end_to_end("kmeans.sift1m-ivf4096")}
    assert "jobs.first_wall_s" not in {
        m["name"] for m in bench.per_layer("kmeans.sift1m-ivf4096")}


def test_an_added_cell_runs(tmp_path, capsys, monkeypatch):
    """The harness runs the added cell end to end on the CPU."""
    from portbench import run

    shutil.copytree(HOME, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    _add_cell(tmp_path)
    monkeypatch.setattr(run, "CHECKOUT", tmp_path)
    monkeypatch.setattr(run, "Bench", lambda root: Bench(
        root, home=tmp_path / "portbench"))
    rc = run.main(["--workload", "kmeans.tiny", "--seed", "7", "--seconds",
                   "0.2", "--trace", "0"], backend="cpu")
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metrics"]["jobs_done"]["value"] >= 1
    assert set(res["metrics"]) == {"setup_s", "jobs_done"}


def test_published_sizes_are_the_sizes_run():
    bench = Bench(CHECKOUT)
    km = bench.config("sift1m-ivf4096")
    assert (km["n"], km["d"]) == (km["dataset"]["n"], km["dataset"]["d"])
    assert km["n_list"] == km["job_params"]["kmeans_k"]
    assert km["niter"] == km["job_params"]["kmeans_iters"]
    assert km["max_points_per_centroid"] * km["n_list"] >= km["n"]
    assert km["job_params"]["kmeans_precision"] == "highest"
    wc = bench.config("hibench-wordcount-large")
    assert wc["datasize"] == wc["dataset"]["total_bytes"] == 3_200_000_000
    assert wc["dataset"]["vocab_size"] == 1000
    for cfg in (km, wc):
        assert cfg["reduced"] == [] and cfg["limits"] and cfg["assumed"]
        assert len(cfg["source"]) <= 200
