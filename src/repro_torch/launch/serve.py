"""Serve the paper's sparse-FFNN workload on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --sparse-ffnn

Feature vectors go through a block-magnitude-pruned sparse FFNN — by default
the paper's BERT-large encoder FFNN, 1024 -> 4096 -> 1024, density 0.1,
128x128 tiles, gelu hidden epilogue, Connection Reordering at 300
iterations — compiled once by the engine, fanned out across power-of-two
batch buckets, and served by the step-driven wait-or-fire scheduler.  Every
forward is one ``bsr_megakernel`` launch; ``--no-fuse`` runs one
``bsr_matmul`` launch per layer instead.  ``--gate`` compiles with runtime
tile-occupancy gating (each forward is one launch of the gated megakernel),
samples the measured dynamic I/O of every batch into the server's
``IOTelemetry``, and prints the dynamic I/O report of one batch after
serving.  ``--device cpu`` runs the kernels' plain versions on the CPU.

Port of ``repro.launch.serve --sparse-ffnn`` (its step-driven mode); the
same request stream comes from the same numpy seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.blocksparse import BSRLayer
from ..engine import Engine
from ..serving import BucketedPlanSet, SparseServer
from ..sparse import prune_dense_stack


def make_ffnn_layers(sizes: Sequence[int], density: float, block: int,
                     seed: int = 0) -> List[BSRLayer]:
    """The served net: random dense layers from ``seed``, block-pruned."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((sizes[i], sizes[i + 1])).astype(np.float32) * 0.03
          for i in range(len(sizes) - 1)]
    bs = [np.zeros(s, np.float32) for s in sizes[1:]]
    return prune_dense_stack(ws, bs, density=density,
                             block_m=block, block_n=block)


@dataclasses.dataclass
class ServeReport:
    """What one serving run did: the requests, their answers, the server."""

    server: SparseServer
    inputs: Dict[int, np.ndarray]              # rid -> request row
    outputs: Dict[int, Optional[np.ndarray]]   # rid -> collected answer
    forwards: int                              # plan forwards of this run


def build_server(args) -> Tuple[BucketedPlanSet, SparseServer]:
    """Compile the net into a warmed bucketed plan set and its server."""
    engine = Engine(activation="gelu", reorder=True,
                    reorder_iters=args.reorder_iters,
                    fuse=not args.no_fuse, gate=args.gate,
                    weight_dtype=args.weight_dtype, device=args.device)
    layers = make_ffnn_layers(args.ffnn_sizes, args.density, args.block)
    t0 = time.time()
    plans = BucketedPlanSet.compile(layers, engine=engine,
                                    max_batch=args.batch)
    print(f"engine compile: {time.time() - t0:.1f}s [cold] — "
          f"{plans.describe()}")
    plans.warmup()
    # gating makes the measured dynamic-I/O path available: sample every
    # batch into the server's I/O telemetry
    server = SparseServer(plans, max_queue=args.max_queue,
                          slo_ms=args.slo_ms,
                          measure_dynamic_every=1 if args.gate else 0)
    return plans, server


def drive(server: SparseServer, args) -> ServeReport:
    """Submit ``args.requests`` rows in random bursts, polling between
    bursts so the wait-or-fire policy forms mixed batch sizes, then drain
    and collect every answer."""
    rng = np.random.default_rng(0)
    n_in = server.plans.n_in
    calls0 = sum(server.plans.bucket_calls.values())
    inputs: Dict[int, np.ndarray] = {}
    pending = args.requests
    while pending:
        burst = int(rng.integers(1, args.batch + 1))
        for _ in range(min(burst, pending)):
            x = rng.standard_normal(n_in).astype(np.float32)
            rid = server.submit(x)
            if rid is not None:
                inputs[rid] = x
            pending -= 1
        server.poll()
    server.drain()
    outputs = {rid: server.result(rid) for rid in inputs}
    return ServeReport(
        server=server, inputs=inputs, outputs=outputs,
        forwards=sum(server.plans.bucket_calls.values()) - calls0)


def serve_sparse_ffnn(args) -> ServeReport:
    """Build, serve and report — what ``--sparse-ffnn`` runs."""
    plans, server = build_server(args)
    report = drive(server, args)
    collected = sum(y is not None for y in report.outputs.values())
    print(f"served {server.metrics.served} sparse-FFNN requests "
          f"({collected} collected) — {server.metrics.summary()}")
    print(f"bucket calls: "
          f"{ {b: n for b, n in plans.bucket_calls.items() if n} }")
    base = plans.base
    if args.gate and base._measure is not None:
        # measured dynamic I/O of one representative batch: how many
        # scheduled weight blocks a demand-driven stream actually read
        rng = np.random.default_rng(1)
        xs = rng.standard_normal((min(args.batch, 8), base.n_in)).astype(
            np.float32)
        print(base.measure_dynamic(xs).summary())
    return report


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sparse-ffnn", action="store_true", required=True,
                    help="serve the paper's sparse-FFNN workload (the only "
                         "workload this port serves so far)")
    ap.add_argument("--ffnn-sizes", type=int, nargs="+",
                    default=[1024, 4096, 1024])
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--reorder-iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4,
                    help="largest batch the scheduler forms (top bucket)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="target end-to-end latency SLO of the scheduler")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission bound of the serving queue")
    ap.add_argument("--no-fuse", action="store_true",
                    help="serve with per-layer dispatch (one bsr_matmul "
                         "launch per layer) instead of the megakernel")
    ap.add_argument("--gate", action="store_true",
                    help="runtime tile-occupancy gating: skip weight blocks "
                         "whose input tile is all-zero for the batch "
                         "(bit-exact; prints the measured dynamic I/O report "
                         "after serving)")
    ap.add_argument("--weight-dtype", default="f32",
                    choices=("f32", "bf16", "fp8"),
                    help="storage dtype of the streamed weight blocks "
                         "(bf16/fp8: one f32 scale per block, dequantized "
                         "in the kernel)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    serve_sparse_ffnn(parse_args(argv))


if __name__ == "__main__":
    main()
