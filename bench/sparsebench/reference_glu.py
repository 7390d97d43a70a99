"""The plain reference of a block-pruned gated (SwiGLU) FFN.

``y = (act(x @ Wg + bg) * (x @ Wu + bu)) @ Wd + bd``, the feed-forward
block of a gated-linear transformer layer (MiniCPM-SALA's, with ``act`` =
silu and no biases), after block pruning: the gate and up matrices keep the
``round(density * blocks)`` block pairs of largest joint Frobenius norm
``sqrt(|G_ij|^2 + |U_ij|^2)`` (one mask for both), the down matrix its
blocks by their own norm.  It prunes the benchmark's dense weights again
itself and computes with dense products in float32, TF32 off.  It imports
numpy, torch and the helpers of ``sparsebench.reference``: nothing of the
program under test and nothing of JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .reference import (
    _matmul_precision,
    activation,
    block_mask,
    pruned,
    round_tf32,
)


def pair_mask(w_gate: np.ndarray, w_up: np.ndarray, block: int,
              density: float) -> np.ndarray:
    """Which ``block x block`` (gate, up) block pairs survive pruning to
    ``density``: the ``round(density * blocks)`` pairs (at least one) of
    largest joint Frobenius norm.  bool [n_in/block, n_out/block]."""
    n_in, n_out = w_gate.shape
    gi, go = n_in // block, n_out // block
    mass = sum((w.astype(np.float64).reshape(gi, block, go, block) ** 2
                ).sum(axis=(1, 3)) for w in (w_gate, w_up))
    mass = np.sqrt(mass)
    keep = max(1, int(round(density * gi * go)))
    kth = np.sort(mass.ravel())[-keep]
    return mass >= kth


def gate_activation(name: str, y: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return y * torch.sigmoid(y)
    return activation(name, y)


class SparseGLUFFN:
    """The reference net: dense pruned gate, up and down weights on
    ``device``.

    ``masks`` are the kept blocks of each of the program's layers, the
    pair layer's given once for its gate and once for its up blocks
    (``concat(pair, pair, axis=1)``), then the down layer's: what
    ``sparsebench.work.forward_work`` counts.  ``precision="tf32"`` is the
    control, as in ``sparsebench.reference.SparseFFNN``.
    """

    def __init__(self, w_gate: np.ndarray, w_up: np.ndarray,
                 w_down: np.ndarray, block: int, density: float, act: str,
                 final_act: str, device,
                 biases: Optional[Sequence[np.ndarray]] = None):
        pair = pair_mask(w_gate, w_up, block, density)
        down = block_mask(w_down, block, density)
        self.masks: List[np.ndarray] = [
            np.concatenate([pair, pair], axis=1), down]
        self.w = [torch.from_numpy(pruned(w, m, block)).to(device)
                  for w, m in ((w_gate, pair), (w_up, pair), (w_down, down))]
        if biases is None:
            biases = [np.zeros(w.shape[1], np.float32)
                      for w in (w_gate, w_up, w_down)]
        self.b = [torch.from_numpy(np.asarray(b, np.float32)).to(device)
                  for b in biases]
        self.block = block
        self.act, self.final_act = act, final_act

    def layer_inputs(self, x: torch.Tensor,
                     precision: str = "f32") -> List[torch.Tensor]:
        """x, the gated hidden ``act(x Wg + bg) * (x Wu + bu)``, then the
        output."""
        tf32 = precision == "tf32"
        if precision not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        emulate = tf32 and x.device.type != "cuda"
        wg, wu, wd = self.w
        bg, bu, bd = self.b
        with _matmul_precision(tf32):
            xi = round_tf32(x) if emulate else x
            if emulate:
                wg, wu, wd = (round_tf32(w) for w in (wg, wu, wd))
            h = gate_activation(self.act, xi @ wg + bg) * (xi @ wu + bu)
            hi = round_tf32(h) if emulate else h
            y = activation(self.final_act, hi @ wd + bd)
        return [x, h, y]

    def __call__(self, x: torch.Tensor, precision: str = "f32"
                 ) -> torch.Tensor:
        return self.layer_inputs(x, precision)[-1]
