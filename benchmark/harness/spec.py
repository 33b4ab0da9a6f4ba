"""Finding a cell and everything it names, by name, from files alone.

- `BENCHMARK.json` at the root of the checkout: the cells, the metrics
  and which cells report which metric.
- `workloads/<cell>.json`: the cell's configuration, traffic and entry
  kind, and the limits of its correctness comparison.
- `configs/<config>.json`: the model configuration as it is run.
- `traffic/<traffic>.json`: the traffic mix's parameters.
- `entries/<entry>.py`, `metrics/<metric>.py`, `reference/<model>.py`,
  `costs/<model>.py`: code, loaded by the names above.

A new cell, configuration, traffic mix or metric is new files and new
entries in `BENCHMARK.json`; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def checked_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict        # the cell's own file
    entry: dict           # its entry in BENCHMARK.json (or a stand-in)
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry.get("chips", 1))

    @property
    def limits(self) -> dict:
        return dict(self.workload.get("limits", {}))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              bench_json: Optional[Path] = None) -> Cell:
    checked_name(name)
    bench_json = bench_json or bench_dir.parent / "BENCHMARK.json"
    bench = load_json(bench_json)
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    entry = next((w for w in bench.get("workloads", [])
                  if w.get("name") == name), None)
    if entry is None:
        raise ValueError(f"{bench_json} has no workload named {name!r}")
    for key in ("config", "traffic"):
        if entry[key] != workload[key]:
            raise ValueError(
                f"cell {name}: BENCHMARK.json names {key} {entry[key]!r}, "
                f"its file {workload[key]!r}")
    config = load_json(bench_dir / "configs"
                       / f"{checked_name(workload['config'])}.json")
    traffic = load_json(bench_dir / "traffic"
                        / f"{checked_name(workload['traffic'])}.json")
    end_to_end = [m for m in bench.get("end_to_end", [])
                  if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench.get("per_layer", [])
                 if (name in m["workloads"] if "workloads" in m
                     else m.get("moves") in reported)]
    return Cell(name=name, workload=workload, entry=entry, config=config,
                traffic=traffic, end_to_end=end_to_end, per_layer=per_layer,
                bench_dir=bench_dir)


def load_code(bench_dir: Path, kind: str, name: str):
    """The module `<bench_dir>/<kind>/<name>.py`.  Names may hold dots,
    so it is loaded from its path; the benchmark's own package is
    importable beside it (for the shared code the module imports)."""
    checked_name(name)
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    key = f"_bench_{kind}_{name.replace('.', '_').replace('-', '_')}" \
          f"_{abs(hash(str(path)))}"
    module = sys.modules.get(key)
    if module is None:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return module


def model_modules(cell: Cell):
    """(reference module, cost module) of the cell's configuration."""
    ref = importlib.import_module(
        f"benchmark.reference.{checked_name(cell.config['reference'])}")
    costs = importlib.import_module(
        f"benchmark.costs.{checked_name(cell.config['costs'])}")
    return ref, costs
