"""Work counts of a sparse forward, and the chip's peaks, for the rooflines.

The counts come from the benchmark's own pruning (``reference.block_mask``)
and the inputs of each layer as the reference computes them, never from the
program's reports.  FLOPs count ``2 * rows * block**2`` for every kept block
whose input tile is live (some row holds a nonzero in it): sparse work, not
the dense equivalent.  Bytes count x read once, y written once, and every
live block and every bias read once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

#: Published peaks (NVIDIA's data sheet, SXM part, dense, 700 W): float32
#: outside the tensor cores, the arithmetic the configurations state, and
#: HBM bandwidth.  Keyed by ``torch.cuda.get_device_name()``.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}

F32 = 4


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def live_tiles(h: torch.Tensor, block: int) -> np.ndarray:
    """bool [n/block]: which tiles of ``h`` [rows, n] hold a nonzero."""
    rows, n = h.shape
    return (h.reshape(rows, n // block, block) != 0).any(dim=2).any(
        dim=0).cpu().numpy()


def forward_work(layer_inputs: Sequence[torch.Tensor],
                 masks: Sequence[np.ndarray], block: int) -> Dict[str, int]:
    """FLOPs and bytes of one forward over the batch whose layer inputs
    (and output, last) are ``layer_inputs``; ``masks[k]`` [gi, go] are the
    kept blocks of layer ``k``."""
    rows = int(layer_inputs[0].shape[0])
    blocks = 0
    bias_bytes = 0
    for h, mask in zip(layer_inputs[:-1], masks):
        live = live_tiles(h, block)
        blocks += int(mask[live].sum())
        bias_bytes += mask.shape[1] * block * F32
    x, y = layer_inputs[0], layer_inputs[-1]
    return {
        "flops": 2 * rows * block * block * blocks,
        "bytes": F32 * (x.numel() + y.numel()) + F32 * block * block * blocks
        + bias_bytes,
        "live_blocks": blocks,
    }


def bound_s(work: Dict[str, int], peak: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of FLOPs over the
    f32 peak and bytes over HBM bandwidth."""
    return max(work["flops"] / peak["f32_flops"],
               work["bytes"] / peak["hbm_bytes_per_s"])

