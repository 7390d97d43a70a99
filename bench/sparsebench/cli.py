"""``python bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the CUDA device it is started on.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a separate, traced run.
The last line of standard output is the result, one JSON object; the last
lines of standard error name each number compared beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from . import work
from .outcome import Outcome, Run
from .spec import Cell, load_cell

#: top-level modules that may not be loaded: JAX and its package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None,
                   help="judge the reference in TF32 in the program's place "
                        "(the comparison's control; not a benchmark run)")
    p.add_argument("--rate", type=float, default=None,
                   help="an open loop's rate instead of its mix's (the sweep "
                        "that sets the mix's rate; not a benchmark run)")
    return p.parse_args(argv)


def run_cell(cell: Cell, r: Run) -> Outcome:
    loop = importlib.import_module(f"sparsebench.loops.{cell.traffic['loop']}")
    out = loop.run(cell, r)
    kind = device_kind(r.device)
    out.obs["kind"] = kind
    out.obs["peaks"] = work.peaks(kind)
    return out


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def judge(cell: Cell, out: Outcome) -> Dict[str, Dict[str, float]]:
    """Each number compared, beside its limit."""
    return {name: {"value": value, "limit": float(cell.limits[name])}
            for name, value in out.compared.items()}


def result(cell: Cell, r: Run, out: Outcome) -> Dict:
    compared = judge(cell, out)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    metrics = {}
    if r.trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
              "kind": out.obs["kind"], "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    stretch = out.obs.get("stretch")
    if r.trace and stretch:
        device["busy_s"] = stretch["busy_s"]
        device["window_s"] = stretch["window_s"]
        line["breakdown"] = {"device_ops": stretch["device_ops"],
                             "idle_gaps": stretch["idle_gaps"]}
    line["compared"] = compared
    return line


def _json(obj) -> str:
    # an infinite gap prints as a string: the line stays JSON
    def fix(v):
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [fix(x) for x in v]
        return v
    return json.dumps(fix(obj))


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}. "
              "The benchmark measures the card and never falls back to the "
              "CPU.", file=sys.stderr)
        return 2
    r = Run(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=torch.device("cuda", 0), t_process=t_process,
            control=args.control, rate=args.rate)
    out = run_cell(cell, r)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    line = result(cell, r, out)
    print(_json({"info": out.info}), flush=True)
    print(_json(line), flush=True)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0
