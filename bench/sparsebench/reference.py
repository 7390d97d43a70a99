"""The plain reference of a block-pruned sparse FFNN.

It prunes the benchmark's dense weights again, block by block, and computes
``act(x @ W1 + b1) ... @ Wn + bn`` with dense products in float32 and TF32
off.  It imports numpy and torch only: nothing of the program under test and
nothing of JAX, so nothing the program made can leak into the yardstick.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence

import numpy as np
import torch


def block_mask(w: np.ndarray, block: int, density: float) -> np.ndarray:
    """Which ``block x block`` blocks of ``w`` [n_in, n_out] survive
    block-magnitude pruning to ``density``: the ``round(density * blocks)``
    blocks of largest Frobenius norm (at least one).  bool [n_in/block,
    n_out/block]."""
    n_in, n_out = w.shape
    gi, go = n_in // block, n_out // block
    tiles = w.astype(np.float64).reshape(gi, block, go, block)
    mass = np.sqrt((tiles ** 2).sum(axis=(1, 3)))
    keep = max(1, int(round(density * gi * go)))
    kth = np.sort(mass.ravel())[-keep]
    return mass >= kth


def pruned(w: np.ndarray, mask: np.ndarray, block: int) -> np.ndarray:
    """``w`` with every block outside ``mask`` set to zero."""
    full = np.repeat(np.repeat(mask, block, axis=0), block, axis=1)
    return np.where(full, w, np.float32(0)).astype(np.float32)


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))


def activation(name: str, y: torch.Tensor) -> torch.Tensor:
    if name == "none":
        return y
    if name == "relu":
        return torch.clamp_min(y, 0.0)
    if name == "gelu":
        return gelu_tanh(y)
    raise ValueError(f"the reference has no activation {name!r}")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


class SparseFFNN:
    """The reference net: dense pruned weights on ``device``.

    ``precision="f32"`` is the reference itself.  ``"tf32"`` is its
    control: the same products in TF32, on the card through its tensor
    cores and elsewhere by rounding each product's operands to TF32.
    """

    def __init__(self, weights: Sequence[np.ndarray],
                 biases: Sequence[np.ndarray], block: int, density: float,
                 act: str, final_act: str, device):
        self.masks: List[np.ndarray] = [block_mask(w, block, density)
                                        for w in weights]
        self.w = [torch.from_numpy(pruned(w, m, block)).to(device)
                  for w, m in zip(weights, self.masks)]
        self.b = [torch.from_numpy(np.asarray(b, np.float32)).to(device)
                  for b in biases]
        self.block = block
        self.acts = [act] * (len(weights) - 1) + [final_act]

    def layer_inputs(self, x: torch.Tensor,
                     precision: str = "f32") -> List[torch.Tensor]:
        """The input of every layer, then the output: ``len(w) + 1``
        tensors."""
        tf32 = precision == "tf32"
        if precision not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        emulate = tf32 and x.device.type != "cuda"
        out = [x]
        with _matmul_precision(tf32):
            h = x
            for w, b, a in zip(self.w, self.b, self.acts):
                if emulate:
                    h, w = round_tf32(h), round_tf32(w)
                h = activation(a, h @ w + b)
                out.append(h)
        return out

    def __call__(self, x: torch.Tensor, precision: str = "f32"
                 ) -> torch.Tensor:
        return self.layer_inputs(x, precision)[-1]
