"""Shared model components: norms, rope, activations, init helpers.

Port of ``repro.models.common``.  Initializers draw from an explicit
``torch.Generator`` into an existing tensor, on the generator's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 statistics; ``inv * scale`` is cast to the input
    dtype before the product, as the reference does."""
    dt = x.dtype
    xf = x.float()
    ss = (xf * xf).sum(-1, keepdim=True)
    inv = torch.rsqrt(ss / x.shape[-1] + eps)
    return (x * (inv * scale.float()).to(dt)).to(dt)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: Dict[str, Callable] = {
    "gelu": gelu,
    "relu": F.relu,
    "silu": F.silu,
    "squared_relu": squared_relu,
}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  Rotates the
    two halves of the head dim (not interleaved pairs), in f32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)     # [hd/2]
    ang = positions[..., :, None, None].float() * freqs          # [..., S, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# parameters and their init
# --------------------------------------------------------------------------

def param(shape: Sequence[int], device, dtype) -> nn.Parameter:
    """An uninitialized serving parameter (no gradient)."""
    return nn.Parameter(torch.empty(tuple(shape), device=device, dtype=dtype),
                        requires_grad=False)


@torch.no_grad()
def dense_init_(p: torch.Tensor, gen: torch.Generator, in_axis: int = 0) -> None:
    """normal / sqrt(fan_in), fan_in = ``p.shape[in_axis]``; drawn in f32."""
    w = torch.randn(p.shape, generator=gen, device=p.device)
    p.copy_(w / np.sqrt(p.shape[in_axis]))


@torch.no_grad()
def normal_init_(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
