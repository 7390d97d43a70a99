"""What a cell is, found by name: ``BENCHMARK.json`` and the files of
``bench/``.

* a cell is an entry of ``workloads`` in ``BENCHMARK.json``;
* its configuration is ``bench/configs/<config>.json``, whose ``model``
  names the module of ``sparsebench.models`` that builds and checks it;
* its traffic mix is ``bench/traffic/<traffic>.json``, whose ``loop`` names
  the module of ``sparsebench.loops`` that drives it;
* the limits of its comparison are ``bench/limits/<cell>.json``;
* a per-layer metric is read by ``bench/metrics/<metric>.py``'s ``read``.

So a later cell, configuration, mix or metric is a new file and a new entry,
and no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

#: the checkout's root: ``bench/sparsebench/spec.py`` -> ``.``
ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path

    def reader(self, metric: str) -> Callable:
        """``read(obs)`` of ``bench/metrics/<metric>.py``."""
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"sparsebench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell in cells


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    root = Path(root) if root is not None else ROOT
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"pick from {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(root / "bench" / "limits" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)
