"""Training entry point: the reference's resilient loop with checkpoint/restart,
on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --reduced --steps 100 --batch 8 --seq 128 --device cpu

Port of ``repro.launch.train``.  ``--reduced`` uses the small same-family
config; without it the registered config trains at full width and depth.
Parameters are bf16, with f32 master weights and moments in the optimizer
state; ``--device`` is ``cuda`` unless given (without a CUDA device that
raises).  Checkpoints are the reference's files (``--ckpt-dir``, by default
``repro_train`` in the temporary directory).  ``--data-mesh`` and
``--model-mesh`` other than 1 raise: the data and model axes are not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, reduced
from ..data import SyntheticLM, TokenBatcher
from ..engine import Mesh
from ..models import encdec, lm
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw_init
from ..runtime import FaultInjector, ResilientTrainer, StragglerMonitor
from .steps import make_train_step, one_device


@dataclasses.dataclass
class TrainRun:
    """What one ``main`` run did: its config, its trainer (holding the
    final parameters and optimizer state), the trainer's summary and the
    loop's wall time."""

    cfg: ModelConfig
    trainer: ResilientTrainer
    summary: Dict
    seconds: float


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
    drawn on ``device``, every parameter trainable."""
    one_device(mesh, "build")
    mod = encdec if cfg.family == "encdec" else lm
    gen = torch.Generator(device=device).manual_seed(seed)
    params = mod.init(gen, cfg, dtype=dtype).requires_grad_(True)
    opt_state = adamw_init(params)
    return params, opt_state, make_train_step(cfg, opt_cfg, mesh)


def make_batches(cfg: ModelConfig, batch: int, seq: int, device,
                 dtype=torch.bfloat16) -> Callable[[int], Dict]:
    """``step -> batch`` on ``device``, as the reference's ``main`` builds
    them: ``SyntheticLM`` tokens (seed 0) through a ``TokenBatcher``
    (seed 1); the vision stub's embeddings and the encoder's source frames
    are ``standard_normal * 0.05`` from ``default_rng(step)``, in
    ``dtype``."""
    batcher = TokenBatcher(SyntheticLM(vocab=cfg.vocab, seed=0), batch, seq,
                           seed=1)

    def on_device(a: np.ndarray, dt=None) -> torch.Tensor:
        return torch.from_numpy(a).to(device=device, dtype=dt)

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


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    mesh = Mesh(model=args.model_mesh, data=args.data_mesh)
    one_device(mesh, "repro_torch.launch.train")
    device = train_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, microbatch=1)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    params, opt_state, step_fn = build(cfg, mesh, opt_cfg, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"mesh={{'data': {mesh.data}, 'model': {mesh.model}}}")

    batches = make_batches(cfg, args.batch, args.seq, device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    injector = FaultInjector([args.inject_fault_at]
                             if args.inject_fault_at is not None else [])
    trainer = ResilientTrainer(
        step_fn, params, opt_state, ckpt, ckpt_every=args.ckpt_every,
        fault_injector=injector, straggler=StragglerMonitor())
    t0 = time.time()
    summary = trainer.run(batches, args.steps)
    dt = time.time() - t0
    ls = summary["losses"]
    print(f"steps={args.steps} time={dt:.1f}s "
          f"loss {ls[0]:.4f} -> {ls[-1]:.4f} "
          f"restarts={summary['restarts']} "
          f"stragglers={summary['straggler_events']}")
    return TrainRun(cfg, trainer, summary, dt)


if __name__ == "__main__":
    main()
