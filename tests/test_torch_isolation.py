"""The port stands alone: no file of it (nor ``chip_smoke.py``) imports JAX
or the JAX package, importing it loads no JAX, and its entry points demand
a CUDA device unless the CPU is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.engine import pick_device

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "map_oxidize_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "map_oxidize_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, map_oxidize_tpu_torch.cli, "
            "map_oxidize_tpu_torch.runtime.driver, "
            "map_oxidize_tpu_torch.workloads.kmeans, "
            "map_oxidize_tpu_torch.convert, "
            "map_oxidize_tpu_torch.native.build, "
            "map_oxidize_tpu_torch.runtime.checkpoint, "
            "map_oxidize_tpu_torch.runtime.collect, "
            "map_oxidize_tpu_torch.runtime.host_reduce, "
            "map_oxidize_tpu_torch.shuffle, "
            "map_oxidize_tpu_torch.workloads.bigram, "
            "map_oxidize_tpu_torch.workloads.inverted_index, "
            "map_oxidize_tpu_torch.workloads.distinct, "
            "map_oxidize_tpu_torch.runtime.dataflow, "
            "map_oxidize_tpu_torch.workloads.sort, "
            "map_oxidize_tpu_torch.workloads.join, "
            "map_oxidize_tpu_torch.workloads.sessionize, "
            "map_oxidize_tpu_torch.runtime.device_map, "
            "map_oxidize_tpu_torch.ops.device_tokenize\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_is_required_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pick_device("cuda")
    assert pick_device("cpu") == torch.device("cpu")
    assert JobConfig().backend == "cuda"
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"a b a\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(JobConfig(input_path=str(inp), output_path=""))
    with pytest.raises(ValueError, match="backend"):
        JobConfig(backend="tpu").validate()


@pytest.mark.parametrize("workload,kw", [
    ("bigram", {}), ("bigram", {"reduce_mode": "fold"}),
    ("invertedindex", {}), ("invertedindex", {"collect_sort": "device"}),
    ("distinct", {})])
def test_the_collect_route_demands_the_card_too(monkeypatch, tmp_path,
                                                workload, kw):
    """The host collect, the host pair sort and the host register fold
    touch no device, but a job that asked for the card still fails when
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"a b a\nb c\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(JobConfig(input_path=str(inp), output_path="", **kw),
                workload)
    r = run_job(JobConfig(input_path=str(inp), output_path="",
                          backend="cpu", **kw), workload)
    assert r.metrics["records_in"] > 0


@pytest.mark.parametrize("workload", ["sort", "join", "sessionize"])
@pytest.mark.parametrize("collect_sort", ["host", "device"])
def test_the_dataflow_jobs_demand_the_card(monkeypatch, tmp_path, workload,
                                           collect_sort):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs = tmp_path / "r.npy"
    np.save(recs, np.array([[3, 1], [1, 2], [3, 9]], np.uint64))
    kw = dict(input_path=str(recs), output_path="", join_input_path=str(recs),
              collect_sort=collect_sort)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(JobConfig(**kw), workload)
    r = run_job(JobConfig(backend="cpu", **kw), workload)
    assert r.metrics["records_in"] > 0


@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_runs_raise_naming_the_roadmap_item(tmp_path, workload,
                                                    num_shards):
    """Every workload at ``num_shards > 1`` runs on the sharded engines
    (ROADMAP A7) on the CPU and writes its one-shard bytes."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"a b a\nc a b d\n" * 50)
    recs = tmp_path / "r.npy"
    np.save(recs, np.array([[3, 1], [1, 2], [3, 0], [7, 5]], np.uint64))
    runs = [(wl, inp, {}) for wl in (workload, "invertedindex", "distinct")]
    runs.append((workload, inp, {"mapper": "device"}))
    runs += [("sort", recs, {}), ("join", recs, {"join_input_path":
                                                 str(recs)}),
             ("sessionize", recs, {})]
    for i, (wl, path, kw) in enumerate(runs):
        outs = []
        for S in (1, num_shards):
            out = tmp_path / f"{i}_{S}.out"
            r = run_job(JobConfig(input_path=str(path),
                                  output_path=str(out), backend="cpu",
                                  num_shards=S, **kw), wl)
            assert r.metrics["records_in"] > 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], (wl, kw)


@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
def test_device_mapper_runs_on_the_cpu_and_demands_the_card(
        monkeypatch, tmp_path, workload):
    """``mapper='device'`` runs the device mapper on ``backend='cpu'`` (the
    plain tokenizer) and raises without a card on ``backend='cuda'``."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"a b a\nb c a\n")
    r = run_job(JobConfig(input_path=str(inp), output_path="",
                          backend="cpu", mapper="device"), workload)
    assert r.metrics["accumulator_device"] == "cpu"
    assert "device_rows_fed" not in r.metrics  # the device driver ran
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(JobConfig(input_path=str(inp), output_path="",
                          mapper="device"), workload)


@pytest.mark.parametrize("mapper", ["auto", "native"])
def test_failed_native_build_raises_instead_of_swapping(tmp_path,
                                                        monkeypatch, mapper):
    """No compiler: the native mapper raises with the cause and the way
    out, and the Python map never runs."""
    from map_oxidize_tpu_torch.native import build
    from map_oxidize_tpu_torch.workloads import wordcount

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "_lib", None)

    def python_map(*a, **k):
        raise AssertionError("the Python map ran")

    monkeypatch.setattr(wordcount, "tokenize", python_map)
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"a b a\n")
    with pytest.raises(RuntimeError, match="native build failed.*"
                       "--mapper python"):
        run_job(JobConfig(input_path=str(inp), output_path="",
                          backend="cpu", mapper=mapper))
