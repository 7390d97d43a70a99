"""Training entry point: the reference's resilient loop with checkpoint/restart,
on any mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --reduced --steps 100 --batch 8 --seq 128 --device cpu \
        --data-mesh 2 --model-mesh 2

Port of ``repro.launch.train``.  ``--reduced`` uses the small same-family
config; without it the registered config trains at full width and depth.
Parameters are bf16, with f32 master weights and moments in the optimizer
state; ``--device`` is ``cuda`` unless given (without a CUDA device that
raises).  Checkpoints are the reference's files (``--ckpt-dir``, by default
``repro_train`` in the temporary directory).

A ``--data-mesh D --model-mesh M`` run is one process per mesh slot.  Run
alone, ``main`` spawns the D x M processes itself (``launch.mesh.
run_world``); under ``torchrun`` (or in a process that already belongs to a
world of D x M ranks) it joins that world.  The backend is ``nccl`` when
every rank has a card of its own, else ``gloo`` (``launch.mesh.
backend_for``).  Every rank draws the full parameters from the seed and
keeps its slices, so a mesh run starts from a one-device run's weights;
rank 0 prints the reference's lines and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, reduced
from ..data import SyntheticLM, TokenBatcher
from ..kernels.adamw import adamw_fused
from ..models import encdec, lm
from ..models.config import ModelConfig
from ..models.sharding import STATS, axes_from_mesh
from ..optim import OptConfig, adamw_init
from ..runtime import FaultInjector, ResilientTrainer, StragglerMonitor
from ..runtime.elastic import shardings_for
from . import partition, specs
from .mesh import (as_mesh, in_world, join_world, make_test_mesh, run_world)
from .steps import CapturedTrainStep, make_train_step


@dataclasses.dataclass
class TrainRun:
    """What one ``main`` run did: its config, its trainer (holding the
    final parameters and optimizer state; None where ``main`` spawned the
    ranks), the trainer's summary and the loop's wall time, and the
    backend of a run on several ranks.  ``summary["rank"]`` holds this
    rank's figures (peak memory, each step's and each save's seconds, the
    collectives' calls and bytes, the fused AdamW kernel's launches, and on
    one card the CUDA graphs' captures, replays and capture seconds); a
    spawned run's ``summary["ranks"]`` every rank's."""

    cfg: ModelConfig
    trainer: Optional[ResilientTrainer]
    summary: Dict
    seconds: float
    backend: Optional[str] = None


def train_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "training on device 'cuda' needs a CUDA device and none is "
            "available; pass --device cpu to train on the CPU")
    return device


def build(cfg: ModelConfig, mesh, opt_cfg: OptConfig, seed: int = 0,
          dtype=torch.bfloat16, device="cuda"):
    """(model, optimizer state, train step): random weights from ``seed``
    drawn on ``device``, every parameter trainable.  On one CUDA device the
    step is a ``CapturedTrainStep`` (one CUDA graph per batch signature,
    as the reference jits it); on the CPU it is ``make_train_step``'s
    eager step.

    On a bound mesh of several ranks every rank draws the full weights and
    keeps its slices (``partition.params_specs``), the optimizer state
    holds its ZeRO slices (``opt_specs``), and the step reduce-scatters
    the gradients to them, as the reference's ``build`` jits it."""
    mesh = as_mesh(mesh)
    mod = encdec if cfg.family == "encdec" else lm
    gen = torch.Generator(device=device).manual_seed(seed)
    params = mod.init(gen, cfg, dtype=dtype)
    if mesh is None or mesh.size == 1:
        params.requires_grad_(True)
        step = CapturedTrainStep(cfg, opt_cfg, mesh) \
            if next(params.parameters()).device.type == "cuda" \
            else make_train_step(cfg, opt_cfg, mesh)
        return params, adamw_init(params), step
    axes_from_mesh(mesh)
    p_specs = partition.params_specs(mesh, params)
    partition.shard_module(params, p_specs, mesh).requires_grad_(True)
    o_specs = partition.opt_specs(
        mesh, adamw_init(specs.params_shape(cfg)), p_specs)
    opt_state = partition.opt_init(params, o_specs, mesh)
    return params, opt_state, make_train_step(cfg, opt_cfg, mesh,
                                              grad_specs=o_specs["master"])


def make_batches(cfg: ModelConfig, batch: int, seq: int, device,
                 dtype=torch.bfloat16, mesh=None) -> Callable[[int], Dict]:
    """``step -> batch`` on ``device``, as the reference's ``main`` builds
    them: ``SyntheticLM`` tokens (seed 0) through a ``TokenBatcher``
    (seed 1); the vision stub's embeddings and the encoder's source frames
    are ``standard_normal * 0.05`` from ``default_rng(step)``, in
    ``dtype``.  On a mesh, this data rank's rows of each batch
    (``partition.batch_specs``)."""
    batcher = TokenBatcher(SyntheticLM(vocab=cfg.vocab, seed=0), batch, seq,
                           seed=1)
    mesh = as_mesh(mesh)

    def on_device(a: np.ndarray, dt=None) -> torch.Tensor:
        t = torch.from_numpy(a)
        if mesh is not None and mesh.size > 1:
            spec = partition.batch_specs(mesh, {"x": t})["x"]
            t = partition.local_shard(t, spec, mesh)
        return t.to(device=device, dtype=dt)

    def batches(step: int) -> Dict[str, torch.Tensor]:
        b = batcher(step)
        if cfg.modality == "vision_stub":
            rng = np.random.default_rng(step)
            return {"embeds": on_device(
                rng.standard_normal((batch, seq, cfg.d_model)) * 0.05, dtype),
                "labels": on_device(b["labels"])}
        if cfg.family == "encdec":
            rng = np.random.default_rng(step)
            st = seq // cfg.tgt_frac
            return {"src_embeds": on_device(
                rng.standard_normal((batch, seq, cfg.d_model)) * 0.05, dtype),
                "tgt_tokens": on_device(b["tokens"][:, :st]),
                "labels": on_device(b["labels"][:, :st])}
        return {k: on_device(v) for k, v in b.items()}

    return batches


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ["bert-ffnn"],
                    default="granite-moe-1b-a400m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--inject-fault-at", type=int, default=None,
                    help="simulate a node failure at this step (demo/tests)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises without one)")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> ModelConfig:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, microbatch=1)


def train(args: argparse.Namespace, device: torch.device,
          backend: Optional[str] = None) -> TrainRun:
    """The training loop of one rank (the only one, without a mesh)."""
    cfg = config(args)
    mesh = make_test_mesh(args.data_mesh, args.model_mesh)
    if mesh.size > 1:
        mesh = mesh.bind()
    rank0 = mesh.size == 1 or dist.get_rank() == 0
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    params, opt_state, step_fn = build(cfg, mesh, opt_cfg, device=device)
    n_params = sum(p.numel() for p in specs.params_shape(cfg).parameters())
    if rank0:
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
              f"mesh={mesh.shape}")
        if backend is not None:
            print(f"backend={backend} ranks={mesh.size} device={device}")
    shardings = None
    if mesh.size > 1:
        p_shard, o_shard = shardings_for(mesh, cfg, specs.params_shape(cfg),
                                         adamw_init(specs.params_shape(cfg)))
        shardings = {"params": p_shard, "opt": o_shard}
    batches = make_batches(cfg, args.batch, args.seq, device, mesh=mesh)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, shardings=shardings)
    figures = {"step_s": [], "save_s": []}
    for name in ("save", "async_save"):
        setattr(ckpt, name, _timed(getattr(ckpt, name), figures["save_s"]))
    injector = FaultInjector([args.inject_fault_at]
                             if args.inject_fault_at is not None else [])
    STATS.reset()
    launches = adamw_fused.launches
    graphs = (CapturedTrainStep.captures, CapturedTrainStep.replays)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = ResilientTrainer(
        _timed(step_fn, figures["step_s"]), params, opt_state, ckpt,
        ckpt_every=args.ckpt_every, fault_injector=injector,
        straggler=StragglerMonitor())
    t0 = time.time()
    summary = trainer.run(batches, args.steps)
    dt = time.time() - t0
    figures["collectives"] = STATS.snapshot()
    figures["adamw_launches"] = adamw_fused.launches - launches
    figures["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None)
    if isinstance(step_fn, CapturedTrainStep):
        figures["graph"] = {
            "captures": CapturedTrainStep.captures - graphs[0],
            "replays": CapturedTrainStep.replays - graphs[1],
            "capture_s": list(step_fn.capture_s)}
    summary["rank"] = figures
    ls = summary["losses"]
    if rank0:
        print(f"steps={args.steps} time={dt:.1f}s "
              f"loss {ls[0]:.4f} -> {ls[-1]:.4f} "
              f"restarts={summary['restarts']} "
              f"stragglers={summary['straggler_events']}")
        if "graph" in figures:
            g = figures["graph"]
            print(f"cuda graph: captures={g['captures']} "
                  f"replays={g['replays']} capture="
                  f"{sum(g['capture_s']):.1f}s")
        sys.stdout.flush()
    return TrainRun(cfg, trainer, summary, dt, backend)


def _timed(fn: Callable, into: list) -> Callable:
    """``fn`` appending its wall time (to the end of the card's work) to
    ``into``."""
    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out

    return timed


def _spawned_rank(rank: int, device: torch.device, argv, out: str) -> None:
    """One spawned rank of ``main``: train; each rank writes its figures
    (``summary["rank"]``: peak memory, step and save seconds, collectives)
    and rank 0 the summary, for the parent."""
    run = train(parse_args(argv), device, dist.get_backend())
    summary = dict(run.summary)
    with open(f"{out}.{rank}", "w") as f:
        json.dump(summary.pop("rank"), f)
    if rank == 0:
        summary["history"] = [list(map(str, h)) for h in summary["history"]]
        with open(out, "w") as f:
            json.dump({"summary": summary, "seconds": run.seconds}, f)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    device = train_device(args.device)
    world = args.data_mesh * args.model_mesh
    if world == 1:
        return train(args, device)
    if in_world():
        _, dev, backend = join_world(device)
        if dist.get_world_size() != world:
            raise ValueError(f"a {args.data_mesh}x{args.model_mesh} mesh "
                             f"needs {world} ranks, the world has "
                             f"{dist.get_world_size()}")
        return train(args, dev, backend)
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "summary.json")
        backend = run_world(_spawned_rank, world, device, argv, out)
        with open(out) as f:
            done = json.load(f)
        ranks = []
        for r in range(world):
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
        done["summary"]["ranks"] = ranks
    return TrainRun(config(args), None, done["summary"], done["seconds"],
                    backend)


if __name__ == "__main__":
    main()
