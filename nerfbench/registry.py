"""Finds every piece of a cell by its name, so that a new configuration,
traffic mix, per-layer metric or pipeline is added as new files alone:

- ``BENCHMARK.json`` at the root: the cells, the metrics and their bounds;
- a configuration: the ``file`` that its ``configs`` entry names (JSON),
  whose ``pipeline`` key names ``nerfbench/pipelines/<pipeline>.py``;
- a traffic mix: ``nerfbench/traffic/<traffic>.json``;
- a per-layer metric: ``nerfbench/metrics/<name>.py``, a module with
  ``read(ctx) -> float | None``;
- a cell's limits of its correctness comparison:
  ``nerfbench/limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = "nerfbench"


class Benchmark:
    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in self.spec['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self.root / PACKAGE / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _load_json(self.root / PACKAGE / "limits" / f"{workload}.json")

    def metrics(self, section: str, workload: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.spec[section] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        """``read`` of ``nerfbench/metrics/<metric>.py`` (loaded by path: a
        metric's name may hold dots)."""
        path = self.root / PACKAGE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{metric.replace('.', '_')}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no reader {path} for metric {metric!r}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def pipeline(name: str, root: Optional[Path] = None):
    """``nerfbench/pipelines/<name>.py`` (from ``root`` when it has one,
    else from this package)."""
    if root is not None:
        path = Path(root) / PACKAGE / "pipelines" / f"{name}.py"
        if path.exists() and path.resolve().parent != (Path(__file__).parent / "pipelines").resolve():
            spec = importlib.util.spec_from_file_location(f"{PACKAGE}_pipeline_{name}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    return importlib.import_module(f"{PACKAGE}.pipelines.{name}")


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)
