"""A checkout-shaped directory with small cells, for the CPU tests: the
harness runs them end to end through the same files and loops as the
benchmark's own cells, with the program on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from .cli import result, run_cell
from .outcome import Run
from .spec import ROOT, load_cell

TINY_CONFIG = {
    "name": "tiny-ffnn", "source": "https://arxiv.org/abs/2301.01048",
    "model": "sparse_ffnn", "sizes": [128, 256, 128], "density": 0.25,
    "layout_seed": 0,
    "block": 32, "activation": "gelu", "final_activation": "none",
    "reorder_iters": 50, "reorder_seed": 0, "weight_std": 0.1, "bias_std": 0.1,
    "dtype": "float32", "reduced": [],
}
TINY_TRAFFIC = {
    "tiny-online": {
        "loop": "online", "rate_per_s": 300,
        "pool_rows": 64, "max_batch": 8, "slo_ms": 50, "max_queue": 1024,
        "executor_workers": 0, "warm_requests": 8, "grace_s": 30,
        "trace_stretch_s": 0.3},
    "tiny-offline": {
        "loop": "offline", "rows": 64, "pool_batches": 3, "warm_calls": 2,
        "sample_outputs": 4, "trace_stretch_s": 0.2},
}
#: far above the f32 program's gap on these sizes, far below TF32's
TINY_LIMIT = 1e-4


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark's files with the small cells
    ``tiny-ffnn.<mix>`` added as new files and entries."""
    tmp = Path(tmp)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    _write(tmp / "bench" / "configs" / "tiny-ffnn.json", TINY_CONFIG)
    bench["configs"].append({
        "name": "tiny-ffnn", "source": TINY_CONFIG["source"],
        "file": "bench/configs/tiny-ffnn.json", "reduced": [],
        "why": "a small net for the CPU tests"})
    for mix, params in TINY_TRAFFIC.items():
        name = f"tiny-ffnn.{mix}"
        _write(tmp / "bench" / "traffic" / f"{mix}.json", params)
        limits = {"max_err_rel": TINY_LIMIT}
        if params["loop"] == "online":
            limits["lost"] = 0
        _write(tmp / "bench" / "limits" / f"{name}.json", limits)
        bench["workloads"].append({"name": name, "config": "tiny-ffnn",
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU test"})
        like = ("bert-ffnn.online-poisson" if params["loop"] == "online"
                else "bert-ffnn.offline-4096")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    _write(tmp / "BENCHMARK.json", bench)
    return tmp


def tiny_run(root: Path, mix: str, seed: int = 3, seconds: float = 0.5,
             trace: bool = False, control=None):
    """One run of ``tiny-ffnn.<mix>`` on the CPU: (result line, outcome)."""
    cell = load_cell(f"tiny-ffnn.{mix}", root)
    r = Run(seed=seed, seconds=seconds, trace=trace,
            device=torch.device("cpu"), t_process=0.0, control=control)
    out = run_cell(cell, r)
    return result(cell, r, out), out
