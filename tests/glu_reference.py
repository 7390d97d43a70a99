"""The plain reference of a block-pruned gated (SwiGLU) FFN, for the tests.

``y = act_out((act(x Wg + bg) * (x Wu + bu)) Wd + bd)`` after block
pruning: gate and up keep the ``round(density * blocks)`` block pairs of
largest joint Frobenius norm ``sqrt(|G_ij|^2 + |U_ij|^2)`` (one mask for
both), down its blocks by their own norm.  Dense float32 products with TF32
off; ``precision="tf32"`` rounds every product's operands to TF32 (the
control the tolerance must fail).  numpy and torch only: nothing of the
port, the reference package or JAX.  The benchmark keeps its own copy
(``bench/sparsebench/reference_glu.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def joint_mask(w_gate, w_up, block, density):
    gi, go = w_gate.shape[0] // block, w_gate.shape[1] // block
    mass = np.sqrt(sum((w.astype(np.float64).reshape(gi, block, go, block)
                        ** 2).sum(axis=(1, 3)) for w in (w_gate, w_up)))
    keep = max(1, int(round(density * gi * go)))
    return mass >= np.sort(mass.ravel())[-keep]


def own_mask(w, block, density):
    return joint_mask(w, np.zeros_like(w), block, density)


def prune(w, mask, block):
    full = np.repeat(np.repeat(mask, block, axis=0), block, axis=1)
    return np.where(full, w, np.float32(0)).astype(np.float32)


def _tf32(t):
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


ACTS = {"silu": lambda y: y * torch.sigmoid(y), "none": lambda y: y,
        "relu": torch.relu}


class GLUReference:
    def __init__(self, w_gate, w_up, w_down, b_gate, b_up, b_down, block,
                 density, act="silu", final_act="none", skip_gate=False):
        pair = joint_mask(w_gate, w_up, block, density)
        down = own_mask(w_down, block, density)
        self.pair_mask, self.down_mask = pair, down
        self.w = [torch.from_numpy(prune(w, m, block)) for w, m in
                  ((w_gate, pair), (w_up, pair), (w_down, down))]
        self.b = [torch.from_numpy(np.asarray(b, np.float32))
                  for b in (b_gate, b_up, b_down)]
        self.act, self.final_act = ACTS[act], ACTS[final_act]
        # a planted fault the tests must catch: the gate's product left out
        self.skip_gate = skip_gate

    def __call__(self, x, precision="f32"):
        x = torch.as_tensor(x, dtype=torch.float32)
        wg, wu, wd = self.w
        bg, bu, bd = self.b
        if precision == "tf32":
            x, wg, wu, wd = (_tf32(t) for t in (x, wg, wu, wd))
        gate = 1.0 if self.skip_gate else self.act(x @ wg + bg)
        h = gate * (x @ wu + bu)
        if precision == "tf32":
            h = _tf32(h)
        return self.final_act(h @ wd + bd)
