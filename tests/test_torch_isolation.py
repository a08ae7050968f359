"""The port stands alone: no file of it (nor ``chip_smoke.py``) imports JAX
or the JAX package, importing it loads no JAX, and its entry points demand
a CUDA device unless the CPU is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

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
            "map_oxidize_tpu_torch.convert\n"
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


@pytest.mark.parametrize("mapper", ["native", "device"])
def test_unported_mapper_raises_instead_of_swapping(tmp_path, mapper):
    inp = tmp_path / "c.txt"
    inp.write_bytes(b"a b a\n")
    with pytest.raises(NotImplementedError, match="not ported"):
        run_job(JobConfig(input_path=str(inp), output_path="",
                          backend="cpu", mapper=mapper))
