"""Quickstart, on the PyTorch/CUDA port: the paper's pipeline end to end on
a small sparse FFNN (twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. generate a random sparse MLP (paper Appendix A);
2. bound its inference I/O with Theorem 1;
3. run Algorithm 1 under MIN/LRU/RR eviction with the 2-optimal order;
4. improve the order with Connection Reordering (simulated annealing);
5. generate an I/O-*optimal* network for this memory with Compact Growth;
6. lower the same ideas to tile granularity and execute with the port's
   engine: on the card (``--device cuda``, the default) one launch of the
   hand-written CUDA megakernel per forward; with ``--device cpu`` its plain
   PyTorch version.

Steps 1-5 run ``repro_torch.core``, a copy of the reference's, and print
the reference's numbers.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    connection_reordering,
    generate,
    random_ffnn,
    simulate,
    theorem1_bounds,
)
from repro_torch.engine import Engine
from repro_torch.kernels import bsr_matmul as kernels
from repro_torch.kernels.ref import bsr_matmul_ref
from repro_torch.sparse import prune_dense_stack

M = 64  # fast-memory budget (words)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="where step 6 runs (cuda raises without a card)")
args = ap.parse_args()

print("== 1-2. random sparse FFNN + Theorem 1 bounds ==")
net = random_ffnn(width=200, depth=4, density=0.1, seed=0)
b = theorem1_bounds(net)
print(f"W={net.W} N={net.N} I={net.I} S={net.S}")
print(f"total I/O bounds: {b.total_lo} <= IOs <= {b.total_hi} "
      f"(upper/lower = {b.total_hi/b.total_lo:.2f} — Thm 1 guarantees <= 2)")

print("\n== 3. Algorithm 1 with the 2-optimal order ==")
order = net.theorem1_order()
for policy in ("min", "lru", "rr"):
    s = simulate(net, order, M, policy)
    print(f"  {policy.upper():3s}: reads={s.reads} writes={s.writes} "
          f"total={s.total}")

print("\n== 4. Connection Reordering (simulated annealing, T=2000) ==")
res = connection_reordering(net, order, M, T=2000, seed=0)
closed = 100 * (res.initial_ios - res.ios) / max(1, res.initial_ios - b.total_lo)
print(f"  {res.initial_ios} -> {res.ios} I/Os "
      f"({closed:.0f}% of the gap to the lower bound closed)")
x = np.random.default_rng(0).standard_normal(net.I)
np.testing.assert_allclose(net.forward(x, order), net.forward(x, res.order),
                           rtol=1e-5, atol=1e-5)
print("  (network function unchanged — checked)")

print("\n== 5. Compact Growth: an I/O-optimal architecture for M =", M, "==")
cg = generate(M_g=M, n_iters=400, in_degree=4, seed=1)
bb = theorem1_bounds(cg.net)
s = simulate(cg.net, cg.order, M, "min")
print(f"  grown net: W={cg.net.W} N={cg.net.N}; IOs={s.total} "
      f"== lower bound {bb.total_lo}: {s.total == bb.total_lo}")

print(f"\n== 6. tile granularity: the fused inference engine on "
      f"{args.device} ==")
rng = np.random.default_rng(0)
sizes = [256, 512, 256]
ws = [rng.standard_normal((sizes[i], sizes[i + 1])).astype(np.float32) * 0.05
      for i in range(2)]
bs = [np.zeros(sizes[i + 1], np.float32) for i in range(2)]
layers = prune_dense_stack(ws, bs, density=0.3, block_m=64, block_n=64)
# compile once: block DAG -> Theorem-1 order -> CR -> one fused plan
plan = Engine(reorder=True, reorder_iters=300,
              device=args.device).compile(layers)
print(f"  {plan.describe()}")
xb = torch.as_tensor(rng.standard_normal((8, 256)), dtype=torch.float32,
                     device=args.device)
before = kernels.bsr_megakernel.launches
y = plan(xb)  # run many: one megakernel launch for the whole net
launches = kernels.bsr_megakernel.launches - before
ref = xb
for i, lay in enumerate(layers):
    ref = bsr_matmul_ref(ref, lay.rows, lay.cols, torch.as_tensor(lay.blocks),
                         torch.as_tensor(lay.bias), lay.grid_in, lay.grid_out,
                         "relu" if i < 1 else None)
err = float(torch.max(torch.abs(y - ref) / (1 + torch.abs(ref))))
print(f"  engine vs dense oracle rel-err: {err:.2e}; megakernel launches: "
      f"{launches}")
assert plan.io.within_bounds, "simulated I/O must sit inside Theorem 1"
assert err < 1e-4, err
print("\nquickstart OK")
