"""Dense oracles for the kernels (the correctness ground truth).

Products run in full f32: PyTorch's default leaves
``torch.backends.cuda.matmul.allow_tf32`` False, and these oracles assume it
(TF32 keeps about three decimal digits and would swamp the kernels' error).
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from .bsr_matmul import apply_activation


def bsr_to_dense(rows, cols, blocks: torch.Tensor, grid_in: int,
                 grid_out: int) -> torch.Tensor:
    """Scatter BSR blocks into the dense [n_in, n_out] weight matrix."""
    bm, bn = blocks.shape[1], blocks.shape[2]
    w = torch.zeros((grid_in * bm, grid_out * bn), dtype=blocks.dtype,
                    device=blocks.device)
    for r, c, b in zip(np.asarray(rows).tolist(), np.asarray(cols).tolist(),
                       blocks):
        w[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn] = b
    return w


def bsr_matmul_ref(
    x: torch.Tensor,
    rows: np.ndarray,
    cols: np.ndarray,
    blocks: torch.Tensor,
    bias: torch.Tensor,
    grid_in: int,
    grid_out: int,
    activation: Union[str, Callable, None] = "none",
) -> torch.Tensor:
    """Oracle: y = act(x @ dense(W) + b), accumulated in float32."""
    w = bsr_to_dense(rows, cols, blocks, grid_in, grid_out)
    y = x.float() @ w.float().to(x.device)
    y = y + bias.float().to(x.device)
    return apply_activation(y, activation).to(x.dtype)


def moe_gemm_ref(
    x: torch.Tensor,          # [tokens, d]
    w_up: torch.Tensor,       # [experts, d, f]
    w_down: torch.Tensor,     # [experts, f, d]
    assign: torch.Tensor,     # [tokens, k] expert ids
    gates: torch.Tensor,      # [tokens, k]
    activation: Union[str, Callable, None],
) -> torch.Tensor:
    """Oracle for the grouped expert FFN: sum_k g_k * FFN_{e_k}(x)."""
    x32 = x.float()
    out = torch.zeros_like(x32)
    for k in range(assign.shape[1]):
        e = assign[:, k].long()
        up = torch.einsum("td,tdf->tf", x32, w_up.float()[e])
        h = apply_activation(up, activation)
        dn = torch.einsum("tf,tfd->td", h, w_down.float()[e])
        out = out + gates[:, k:k + 1].float() * dn
    return out.to(x.dtype)
