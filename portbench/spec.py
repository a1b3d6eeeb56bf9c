"""What a run reads, found by name: the cell in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, whose "kind" names the loop
`traffic/<kind>.py`), the limits of its output check
(`limits/<cell>.json`) and one reader per per-layer metric
(`metrics/<metric>.py`).  A cell, a configuration, a traffic mix or a
metric is added by adding files and entries; no code names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Mapping, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with "name"
    traffic: dict           # traffic/<traffic>.json, with "name"
    limits: dict            # limits/<cell>.json
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    root: Path              # the folder the files came from

    def kind(self) -> ModuleType:
        return load_module(self.root / "traffic" / f"{self.traffic['kind']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{metric}.py")


def load_module(path: Path) -> ModuleType:
    """A Python file as a module, by its path (metric names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def _reports(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Optional[Path] = None, root: Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (at the repo root unless given) with
    the files it names under `root`."""
    bench = _json(benchmark or REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json(root / "configs" / f"{w['config']}.json"), name=w["config"])
    if config["name"] not in configs:
        raise KeyError(f"configuration {config['name']!r} is not in BENCHMARK.json")
    traffic = dict(_json(root / "traffic" / f"{w['traffic']}.json"), name=w["traffic"])
    limits = _json(root / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)], root=root)
