"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells, and the metrics.  Everything that belongs to one configuration,
one traffic mix or one metric sits in a file of its own, found by name:

- ``configs/<config>.json`` (the manifest's ``file``): the deployment,
  its dataset, its job parameters and the limits of its comparison;
- ``mixes/<traffic>.json``: the traffic, which the one traffic driver in
  ``run.py`` reads;
- ``generators/<dataset.generator>.py``: ``generate(spec, seed, out_dir,
  device)`` makes a dataset;
- ``reference/<job>.py``: ``check(cfg, dataset, outputs, device)``, the
  plain reference and its comparison, and ``control_outputs``;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``:
  ``read(run)``, the metric's number from a finished run, or None where
  the run has nothing to read.

A later cell, traffic or metric is a new file and a new manifest entry;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_module(path: Path, tag: str):
    """The module in ``path``, under a private name (the file names of
    metrics carry dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Bench:
    """The manifest at ``root`` (a checkout) and the harness files in
    ``home`` (by default this directory)."""

    root: Path
    home: Path = HERE
    manifest: dict = field(init=False)

    def __post_init__(self):
        self.root = Path(self.root)
        self.home = Path(self.home)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return json.loads((self.home / "mixes" / f"{traffic}.json")
                          .read_text())

    def generator(self, name: str):
        return load_module(self.home / "generators" / f"{name}.py",
                           f"gen_{name}")

    def reference(self, job: str):
        return load_module(self.home / "reference" / f"{job}.py",
                           f"ref_{job}")

    def _reports(self, metric: dict, cell: str, e2e_names: set) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves") in e2e_names if "moves" in metric else True

    def end_to_end(self, cell: str) -> list[dict]:
        """The cell's end-to-end metrics, in manifest order."""
        return [m for m in self.manifest["end_to_end"]
                if self._reports(m, cell, set())]

    def per_layer(self, cell: str) -> list[dict]:
        """The cell's per-layer metrics: those that list it, and those
        without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if self._reports(m, cell, e2e)]

    def reader(self, kind: str, name: str):
        """``read`` of an ``end_to_end`` or ``layer_metrics`` file."""
        return load_module(self.home / kind / f"{name}.py",
                           f"{kind}_{name.replace('.', '_')}").read
