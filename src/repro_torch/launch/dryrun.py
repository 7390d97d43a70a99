"""Multi-pod dry run: trace every (arch x shape) on the production meshes,
print memory and cost analysis, and emit roofline JSON artifacts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nemotron-4-15b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Port of ``repro.launch.dryrun``, which compiles each cell for 512 forced
host devices and reads XLA's memory and cost analysis.  Here each cell
starts a fake world of ``mesh.size`` ranks (the ``fake`` backend: no
process, no communication), binds ``make_production_mesh`` as rank 0 and
builds rank 0's slices of the model, optimizer state, batch or caches on
``meta`` tensors (``launch.specs``, ``launch.partition``); the program is
SPMD, so rank 0's cost is every rank's.  ``cost_analysis.analyze_step``
traces one step and ``roofline`` prices it for an H100.  Nothing is
computed and no device is needed.

Artifacts go to ``$REPRO_DRYRUN_DIR``, or else to ``repro_dryrun`` in the
temporary directory; they carry the reference's keys, with ``trace_s`` in
place of ``lower_s`` / ``compile_s``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import tempfile
import time
import traceback
from typing import Any, Dict, Mapping

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..models.config import LM_SHAPES, applicable_shapes
from ..models.sharding import STATS, axes_from_mesh, set_mesh, set_mesh_axes
from ..optim import OptConfig, adamw_init
from . import cost_analysis, partition, specs, steps
from .mesh import make_production_mesh

ARTIFACT_DIR = os.environ.get(
    "REPRO_DRYRUN_DIR", os.path.join(tempfile.gettempdir(), "repro_dryrun"))


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item"):
        return x.item()
    return x


def _coerce(cfg, key: str, val: str):
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake world of ``size`` ranks; torn down
    afterwards, failure or not, with the collective counters and the
    logical axes and mesh of ``models.sharding``."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        STATS.reset()
        set_mesh(None)
        set_mesh_axes()


def _local(tree, spec_tree, mesh):
    """Fresh ``meta`` tensors of this rank's slices of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _local(v, spec_tree[k], mesh) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.empty(partition.local_shape(tree.shape, spec_tree, mesh),
                       dtype=tree.dtype, device="meta")


def _no_grad(step):
    def run(*args):
        with torch.no_grad():
            return step(*args)

    return run


def build_cell(cfg, shape, mesh):
    """(step, args) of rank 0 of ``mesh`` (bound) for one cell, every
    tensor on ``meta``."""
    full = specs.params_shape(cfg)
    p_specs = partition.params_specs(mesh, full)
    params = partition.shard_module(full, p_specs, mesh, device="meta")
    if shape.kind == "train":
        params.requires_grad_(True)
        o_specs = partition.opt_specs(
            mesh, adamw_init(specs.params_shape(cfg)), p_specs)
        opt = partition.opt_init(params, o_specs, mesh)
        batch = specs.train_inputs(cfg, shape)
        batch = _local(batch, partition.batch_specs(mesh, batch), mesh)
        step = steps.make_train_step(cfg, OptConfig(), mesh,
                                     grad_specs=o_specs["master"])
        return step, (params, opt, batch)
    params.requires_grad_(False)
    if shape.kind == "prefill":
        batch = specs.prefill_inputs(cfg, shape)
        batch = _local(batch, partition.batch_specs(mesh, batch), mesh)
        return _no_grad(steps.make_prefill_step(cfg, mesh)), (params, batch)
    caches, tok = specs.decode_inputs(cfg, shape)
    caches = _local(caches, partition.cache_specs(mesh, cfg, caches), mesh)
    tok = _local(tok, partition.batch_specs(mesh, tok), mesh)["tokens"]
    return _no_grad(steps.make_serve_step(cfg, mesh)), (params, caches, tok)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             moe_impl: str = None, quiet: bool = False, tag: str = "",
             overrides=None) -> Dict[str, Any]:
    cfg = get_config(arch)
    if moe_impl and cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    for kv in overrides or []:
        key, val = kv.split("=", 1)
        cfg = dataclasses.replace(cfg, **{key: _coerce(cfg, key, val)})
    shape = LM_SHAPES[shape_name]
    desc = make_production_mesh(multi_pod=multi_pod)
    n_chips = desc.size
    t0 = time.time()
    with fake_world(n_chips):
        mesh = desc.bind()
        axes_from_mesh(mesh)
        set_mesh(mesh)
        step, args = build_cell(cfg, shape, mesh)
        cost, mem = cost_analysis.analyze_step(step, *args)
        del step, args
    t_trace = time.time() - t0

    coll = cost_analysis.collective_stats(cost)
    mf = cost_analysis.model_flops_for(cfg, shape)
    rl = cost_analysis.roofline(cost, coll, n_chips, mf, mem)

    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n_chips,
        "status": "ok",
        "trace_s": round(t_trace, 1),
        "memory": mem.record(),
        "roofline": rl.as_dict(),
    }
    if not quiet:
        print(f"[{arch} x {shape_name} x {result['mesh']}] "
              f"trace {t_trace:.0f}s | "
              f"args {mem.argument_size_in_bytes/2**30:.2f} GiB/dev, "
              f"temp {mem.temp_size_in_bytes/2**30:.2f} GiB/dev | "
              f"flops/dev {rl.flops_per_dev:.3e} | "
              f"compute {rl.compute_s*1e3:.2f} ms, memory {rl.memory_s*1e3:.2f} ms, "
              f"collective {rl.collective_s*1e3:.2f} ms -> {rl.dominant}-bound | "
              f"useful {rl.useful_ratio:.2f}")
        print("  memory_analysis:", mem)
        print("  cost_analysis: flops=%.4g bytes=%.4g" %
              (rl.flops_per_dev, rl.bytes_per_dev))
        print("  collectives:", coll.by_op)
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    suffix = f"-{tag}" if tag else ""
    fname = f"{arch}--{shape_name}--{result['mesh'].replace('x','_')}{suffix}.json"
    with open(os.path.join(ARTIFACT_DIR, fname), "w") as f:
        json.dump(_jsonable(result), f, indent=1)
    gc.collect()
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(LM_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--moe-impl", choices=["dense", "a2a"], default=None)
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (repeatable)")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for sh in applicable_shapes(cfg):
                cells.append((arch, sh))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, sh in cells:
        for mp in meshes:
            try:
                run_cell(arch, sh, mp, moe_impl=args.moe_impl, tag=args.tag,
                         overrides=args.overrides)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, sh, mp, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} dry-run cells compiled OK")


if __name__ == "__main__":
    main()
