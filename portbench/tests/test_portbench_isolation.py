"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port (top-level names compared whole: the
port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench.run import FORBIDDEN
from portbench.tests.conftest import CHECKOUT, TINY

HOME = CHECKOUT / "portbench"


def _modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_package():
    tops = _modules(
        "import json, sys; sys.path.insert(0, '.');"
        "import portbench.run, portbench.calibrate;"
        "import map_oxidize_tpu_torch.runtime.driver;"
        "import map_oxidize_tpu_torch.runtime.device_map;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "map_oxidize_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_a_whole_run_loads_no_jax_package():
    tiny = json.dumps(TINY["kmeans.sift1m-ivf4096"])
    code = f"""
import contextlib, io, json, sys
sys.path.insert(0, '.')
from portbench import run
with contextlib.redirect_stdout(io.StringIO()):
    rc = run.main(['--workload', 'kmeans.sift1m-ivf4096', '--seed', '1',
                   '--seconds', '0.1', '--trace', '0'], backend='cpu',
                  overrides={tiny})
assert rc == 0, rc
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    tops = _modules(code)
    assert "map_oxidize_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules(
        "import json, sys; sys.path.insert(0, '.');"
        "from portbench.bench import Bench; from pathlib import Path;"
        "b = Bench(Path('.'));"
        "[b.reference(j) for j in ('kmeans', 'wordcount')];"
        "import portbench.roofline.kmeans_assign_sum,"
        " portbench.roofline.tokenize_compact;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & (set(FORBIDDEN) | {"map_oxidize_tpu_torch"})


def test_reference_sources_import_only_plain_libraries():
    for path in sorted((HOME / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"__future__", "pathlib",
                                              "numpy", "torch"}, (path, name)


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    """In a directory that holds only the manifest and the harness, a run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copytree(HOME, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kmeans.sift1m-ivf4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kmeans.sift1m-ivf4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "TMPDIR": str(tmp_path)})
    assert out.returncode == 3
    assert out.stdout.strip() == ""
