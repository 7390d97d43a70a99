"""Distributed-optimization tricks: gradient compression + quantized reduce.

Port of ``repro.runtime.compression``.

* ``topk_compress_with_feedback`` — per-leaf magnitude top-k sparsification
  with error feedback (Strom'15 / Aji-Heafield'17): the un-sent residual is
  accumulated locally and re-added next step, preserving convergence.
  At k=1% this cuts DP all-reduce bytes ~50x (values + indices).
* ``quantized_psum`` — int8 block-quantized all-reduce emulation: quantize to
  int8 with a per-block scale, sum, dequantize.  As in the reference, the
  sum runs on the dequantized representatives (f32 on the wire), so the
  numerics are exactly those of an int8 wire and tests can bound the
  quantization error.

Trees are mappings of names to tensors, their leaves taken in sorted key
order as ``jax.tree_util`` takes a dict's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.sharding import reduce_


@dataclasses.dataclass
class CompressionState:
    error: Dict[str, torch.Tensor]   # like grads — residual feedback


def init_compression(params) -> CompressionState:
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else dict(params)
    return CompressionState(error={n: torch.zeros(x.shape, dtype=torch.float32,
                                                  device=x.device)
                                   for n, x in named.items()})


def _topk_mask(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    n = x.numel()
    k = max(1, int(round(k_frac * n)))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def topk_compress_with_feedback(
    grads: Mapping[str, torch.Tensor], state: CompressionState,
    k_frac: float = 0.01,
) -> Tuple[Dict[str, torch.Tensor], CompressionState, Dict[str, Any]]:
    """Returns (sparse_grads, new_state, metrics).

    sparse_grads carries only the top-k fraction by magnitude (rest zero);
    the residual goes into the error-feedback accumulator."""
    sent, err, densities = {}, {}, []
    for name in sorted(grads):
        acc = grads[name].float() + state.error[name]
        s = acc * _topk_mask(acc, k_frac)
        sent[name], err[name] = s, acc - s
        densities.append(float((s != 0).float().mean()))
    density = sum(densities) / max(1, len(densities))
    return sent, CompressionState(error=err), {"sent_density": density}


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Block-wise symmetric int8 quantization.  Returns (q, scales, shape,
    pad); ``torch.round`` rounds half to even, as ``jnp.round``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = blocks.abs().amax(1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), pad


def dequantize_int8(q, scale, shape, pad) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def quantized_psum(x: torch.Tensor, mesh, axis: str = "data",
                   block: int = 256) -> torch.Tensor:
    """int8-on-the-wire sum over ``axis`` of a bound mesh: quantize
    locally, sum the representatives, and cut the padding off.  Wire bytes
    of an int8 lowering: 1B/elem + 4B/block vs 4B/elem."""
    q, scale, shape, pad = quantize_int8(x, block)
    summed = reduce_(q.float() * scale, mesh, axis)
    flat = summed.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)
