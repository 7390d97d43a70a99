"""The grouped expert FFN (MoE) kernel, its plain version and launch count.

``moe_ffn`` replaces the Pallas kernel ``repro.kernels.moe_ffn.moe_ffn``:
``out[e] = act(x[e] @ Wu[e]).astype(x.dtype) @ Wd[e]`` over capacity-grouped
tokens, with the hidden tile kept on chip and an f32 accumulator spanning
the f-tiles.  The kernel is CUDA C++ for ``sm_90a`` in ``csrc/moe_ffn.cu``
(built with the BSR kernels by ``_build``); the source's header notes what
bounds it on the H100 and what its design does about it.

A CUDA tensor launches the kernel on ``torch.cuda.current_stream()`` (or
raises — there is no fallback); a CPU tensor runs ``moe_ffn_plain``, which
walks the same f-tiles with f32 products.  ``moe_ffn.launches`` counts
kernel launches (plain-version calls are not counted).
"""

from __future__ import annotations

import torch

from . import _build
from .bsr_matmul import Activation, activation_code, apply_activation

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's shared memory: x rows and the accumulator, [16, round4(d)]
# f32 each, and h, [16, round4(f_tile)] f32 (keep in step with moe_ffn.cu)
_TILE_ROWS = 16
_MAX_SMEM = 232448                  # bytes a CTA may use on the H100


def _round4(n: int) -> int:
    return (n + 3) & ~3


def moe_ffn_plain(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                  activation: Activation = "gelu",
                  f_tile: int = 512) -> torch.Tensor:
    """Plain version of ``moe_ffn``: per f-tile, ``h`` in f32, rounded to
    ``x.dtype``, then added into an f32 accumulator."""
    f = w_up.shape[2]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xf = x.float()
    for f0 in range(0, f, f_tile):
        h = apply_activation(torch.bmm(xf, w_up[:, :, f0:f0 + f_tile].float()),
                             activation)
        h = h.to(x.dtype).float()
        acc = acc + torch.bmm(h, w_down[:, f0:f0 + f_tile, :].float())
    return acc.to(x.dtype)


def moe_ffn(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
            activation: Activation = "gelu", f_tile: int = 512) -> torch.Tensor:
    """Fused grouped expert FFN.

    ``x`` [E, C, d], ``w_up`` [E, d, f] and ``w_down`` [E, f, d], all
    float32 or all bfloat16; the output is [E, C, d] in ``x.dtype``.
    ``activation`` is an epilogue name of the kernels' table (the default,
    gelu, is the tanh form, as the reference's ``jax.nn.gelu``); ``f`` must
    be a multiple of ``f_tile``.
    """
    E, C, d = x.shape
    if w_up.ndim != 3 or w_down.ndim != 3:
        raise ValueError("moe_ffn: w_up and w_down must be [E, d, f] and "
                         "[E, f, d]")
    f = w_up.shape[2]
    if tuple(w_up.shape) != (E, d, f) or tuple(w_down.shape) != (E, f, d):
        raise ValueError(f"moe_ffn: w_up {tuple(w_up.shape)} and w_down "
                         f"{tuple(w_down.shape)} do not fit x {tuple(x.shape)}")
    if f % f_tile:
        raise ValueError("f must be a multiple of f_tile")
    if x.device.type == "cpu":
        return moe_ffn_plain(x, w_up, w_down, activation, f_tile)
    act = activation_code(activation)
    if x.device.type != "cuda":
        raise ValueError(f"moe_ffn: x must lie on the CPU or a CUDA device, "
                         f"got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"moe_ffn: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    for name, t in (("x", x), ("w_up", w_up), ("w_down", w_down)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"moe_ffn: {name} is {t.dtype} on {t.device}; "
                             f"x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"moe_ffn: {name} must be contiguous")
    smem = 4 * _TILE_ROWS * (2 * _round4(d) + _round4(f_tile))
    if smem > _MAX_SMEM:
        raise ValueError(f"moe_ffn: d={d}, f_tile={f_tile} need {smem} B of "
                         f"shared memory per CTA, over {_MAX_SMEM}; use a "
                         "smaller f_tile")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _build.load().moe_ffn_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), out.data_ptr(), E, C, d, f, f_tile, act,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"moe_ffn: kernel launch failed, CUDA error {rc}")
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0
