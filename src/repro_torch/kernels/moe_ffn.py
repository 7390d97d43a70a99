"""The grouped expert FFN (MoE) kernels, their plain version and launch count.

``moe_ffn`` replaces the Pallas kernel ``repro.kernels.moe_ffn.moe_ffn``:
``out[e] = act(x[e] @ Wu[e]).astype(x.dtype) @ Wd[e]`` over capacity-grouped
tokens, with the hidden tile kept on chip and f32 accumulation.  The kernels
are CUDA C++ for ``sm_90a`` in ``csrc/moe_ffn.cu`` (built with the BSR
kernels by ``_build``): bf16 on the tensor cores (``wgmma``, operands staged
by TMA), f32 as a register-tiled FMA product staged by ``cp.async``.  The
source's header notes what bounds them on the H100 and what the designs do
about it.

``moe_tile_plan`` is the launch's plan: token rows per CTA, the depth of the
bf16 staging ring, how many f columns of ``h`` a CTA keeps in shared memory
at once (all of f where it fits), the staging route, and the shared memory
that takes; ``launch`` runs the kernel with a given plan.  ``f_tile`` only
sets the plain version's blocks of f; the kernels sum over their own chunks
of f, which changes only the order of the f32 summation.

A CUDA tensor launches the kernel on ``torch.cuda.current_stream()`` (or
raises — there is no fallback); a CPU tensor runs ``moe_ffn_plain``, which
walks the f-tiles with f32 products.  ``moe_ffn.launches`` counts kernel
launches, exactly under concurrency (plain-version calls are not counted).
The kernel keeps no state between launches, so threads may call it freely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build
from .bsr_matmul import (
    Activation,
    activation_code,
    apply_activation,
    count_launch,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448              # bytes of shared memory a CTA may use (H100)
_SM_SMEM = 233472               # bytes of shared memory an SM has for CTAs
_CTA_RESERVED = 1024            # bytes the hardware reserves per CTA
# keep in step with csrc/moe_ffn.cu
_TILE_ROWS = {torch.float32: 64, torch.bfloat16: 128}   # token rows per CTA
_BF16_STATIC = 64               # the bf16 kernel's mbarriers, rounded up
_BF16_B_TILE = 64 * 128 * 2     # one [64, 128] bf16 weight tile
_BF16_STAGES = (4, 3, 2)
_F32_STAGED = 4 * (2 * 64 * 16 + 2 * 16 * 128)   # the f32 double buffers
_F32_CHUNK = 256                # f columns per chunk when f does not fit


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class MoePlan:
    """One ``moe_ffn`` launch: CTA shape, staging and shared memory."""

    rows: int       # token rows per CTA
    stages: int     # depth of the operand ring (2: f32's double buffer)
    f_chunk: int    # f columns whose h a CTA keeps in shared memory at once
    n_chunks: int   # chunks of f; > 1 carries f32 partial sums in a scratch
    route: str      # bf16: "tma" | "loads"; f32: "cp.async16" | "cp.async4"
    smem: int       # dynamic shared memory per CTA, bytes

    @property
    def route_code(self) -> int:
        return 0 if self.route in ("tma", "cp.async16") else 1


def _bf16_smem(rows: int, stages: int, fc: int) -> int:
    return (1024 + stages * (rows * 128 + _BF16_B_TILE)
            + rows * _round(fc, 64) * 2)


def moe_tile_plan(E: int, C: int, d: int, f: int, dtype: torch.dtype,
                  rows: Optional[int] = None) -> MoePlan:
    """The launch plan for ``x`` [E, C, d] and f hidden columns in ``dtype``.

    bf16: ``rows`` is 64 or 128 (one or two consumer warpgroups; default 64
    for C <= 64, else 128), the deepest ring of 4, 3 or 2 stages with which
    h for all of f fits, else 3 stages and the widest chunk of f (a multiple
    of 64) that fits.  TMA stages the tiles where every row is a multiple of
    16 bytes (d and f multiples of 8), bounds-checked loads otherwise.
    f32: 64 rows, and all of f where two CTAs still fit on an SM, else
    chunks of 256 columns; 16-byte ``cp.async`` where d and f are multiples
    of 4, 4-byte copies otherwise.  Raises ``ValueError`` for an unsupported
    dtype or row count.
    """
    if dtype == torch.bfloat16:
        rows = rows or (64 if C <= 64 else _TILE_ROWS[dtype])
        if rows not in (64, 128):
            raise ValueError(f"moe_ffn: bf16 takes 64 or 128 rows per CTA, "
                             f"got {rows}")
        budget = _MAX_SMEM - _BF16_STATIC
        fc, stages = f, None
        for s in _BF16_STAGES:
            if _bf16_smem(rows, s, f) <= budget:
                stages = s
                break
        if stages is None:
            stages = 3
            fc = (budget - _bf16_smem(rows, stages, 0)) // (rows * 2) // 64 * 64
        route = "tma" if d % 8 == 0 and f % 8 == 0 else "loads"
        return MoePlan(rows=rows, stages=stages, f_chunk=fc,
                       n_chunks=-(-f // fc), route=route,
                       smem=_bf16_smem(rows, stages, fc))
    if dtype == torch.float32:
        rows = rows or _TILE_ROWS[dtype]
        if rows != 64:
            raise ValueError(f"moe_ffn: f32 takes 64 rows per CTA, got {rows}")
        two_ctas = _SM_SMEM // 2 - _CTA_RESERVED
        fc = f if _F32_STAGED + 4 * rows * _round(f, 16) <= two_ctas \
            else _F32_CHUNK
        route = "cp.async16" if d % 4 == 0 and f % 4 == 0 else "cp.async4"
        return MoePlan(rows=rows, stages=2, f_chunk=fc,
                       n_chunks=-(-f // fc), route=route,
                       smem=_F32_STAGED + 4 * rows * _round(fc, 16))
    raise ValueError(f"moe_ffn: x must be float32 or bfloat16, got {dtype}")


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
    return launch(x, w_up, w_down, act, moe_tile_plan(E, C, d, f, x.dtype))


def launch(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           act: int, plan: MoePlan) -> torch.Tensor:
    """Launch the kernel of ``x.dtype`` with ``plan`` on checked CUDA
    tensors (``moe_ffn`` checks them); ``act`` is an activation code."""
    E, C, d = x.shape
    f = w_up.shape[2]
    if any(t.data_ptr() % 16 for t in (x, w_up, w_down)):
        # a tensor map and 16-byte copies need 16-byte-aligned bases
        plan = dataclasses.replace(
            plan, route="loads" if plan.route == "tma" else "cp.async4")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    scratch = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if plan.n_chunks > 1 else None
    rc = _build.load().moe_ffn_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), E, C, d, f,
        plan.rows, plan.stages, plan.f_chunk, plan.route_code, act,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"moe_ffn: kernel launch failed, CUDA error {rc}")
    count_launch(moe_ffn)
    return out


moe_ffn.launches = 0
