"""Mamba2 — state-space duality (SSD) block, chunked (arXiv:2405.21060).

Port of ``repro.models.ssm``.  The SSD recurrence
h_t = a_t·h_{t-1} + (dt_t x_t) ⊗ B_t,  y_t = C_t·h_t + D·x_t  is computed
over chunks of length Q: a quadratic intra-chunk term masked by the decay
kernel plus an inter-chunk state carried from chunk to chunk, and O(1) per
decode step.

Layout: d_inner = expand·d_model split into H = d_inner/P heads of dim P;
B, C are single-group [*, N].  A short causal depthwise conv precedes x, B,
C.  The conv is the reference's shifted f32 sum, not ``F.conv1d``: cuDNN
convolutions may run in TF32 on the card.

Under a ``model`` axis the leaves keep the reference's split (``in_proj``
and ``conv`` by columns, ``out_proj`` by rows), but ``in_proj`` packs
``[z, x, B, C, dt]`` into one dim, so a contiguous column slice is no
Megatron split: each split leaf is gathered before use and every rank runs
the whole block (the gathered leaf's gradient, the same on every rank, is
reduce-scattered back and averaged).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init_, normal_init_, param, rms_norm
from .config import ModelConfig
from .sharding import all_gather, axis_index, axis_size, div_or_none


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * N
        # in_proj packs [z (di), x (di), B (N), C (N), dt (H)]
        self.in_proj = param((d, 2 * di + 2 * N + H), device, dtype)
        self.conv = param((cfg.ssm_conv, conv_ch), device, dtype)
        self.conv_bias = param((conv_ch,), device, dtype)
        self.dt_bias = param((H,), device, torch.float32)
        self.A_log = param((H,), device, torch.float32)
        self.D = param((H,), device, torch.float32)
        self.norm = param((di,), device, dtype)
        self.out_proj = param((di, d), device, dtype)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        dense_init_(self.in_proj, gen)
        normal_init_(self.conv, gen, 0.1)
        self.conv_bias.zero_()
        self.dt_bias.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.norm.fill_(1.0)
        dense_init_(self.out_proj, gen)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    Bm = zxbcdt[..., 2 * di:2 * di + N]
    Cm = zxbcdt[..., 2 * di + N:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, x, Bm, Cm, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S.  xbc: [B, S, Ch]; w: [Kw, Ch]."""
    Kw, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, Kw - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(Kw):
        out = out + pad[:, i:i + S].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def ssd_chunked(x, dt, A_log, Bm, Cm, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: [B, S, H, P]; dt: [B, S, H] (post-softplus); Bm, Cm: [B, S, N].
    Returns (y [B, S, H, P], h_final [B, H, P, N]).
    """
    B, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt = 0 steps: decay a = exp(0) = 1 and zero input, so the
        # state passes through unchanged and padded outputs are discarded.
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    a_log = (-torch.exp(A_log)[None, None] * dt).float()            # [B, S, H]

    xc = x.reshape(B, nc, Q, H, Pd).float()
    dtc = dt.reshape(B, nc, Q, H)
    alc = a_log.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()

    L = torch.cumsum(alc, dim=2)                                      # [B,nc,Q,H]
    Ltot = L[:, :, -1]                                                # [B,nc,H]

    # intra-chunk: scores[t,s] = (C_t·B_s) exp(L_t - L_s) dt_s for t >= s
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)                      # [B,nc,Q,Q]
    decay = L[:, :, :, None, :] - L[:, :, None, :, :]                 # [B,nc,Q,Q,H]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(tri[:, :, None], torch.exp(decay) * cb[..., None], 0.0)
    scores = scores * dtc[:, :, None, :, :]                           # dt_s factor
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xc)

    # per-chunk outgoing state: S_c = sum_s exp(Ltot - L_s) dt_s x_s B_s^T
    w_out = torch.exp(Ltot[:, :, None] - L) * dtc                     # [B,nc,Q,H]
    chunk_state = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w_out, xc, Bc)

    # inter-chunk recurrence over nc
    h = torch.zeros((B, H, Pd, N), device=x.device) if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = torch.exp(Ltot[:, c])[:, :, None, None] * h + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                             # [B,nc,H,P,N]

    # inter-chunk contribution: y_t += C_t · (exp(L_t) h_prev)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(L), h_prevs)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)[:, :S_orig]
    return y.to(x.dtype), h


class _Leaves:
    """The SSM's leaves for one call: each split leaf gathered whole."""

    def __init__(self, p: SSM, cfg: ModelConfig, mesh):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ch = di + 2 * N
        for name, full, dim in (("in_proj", 2 * di + 2 * N + H, 1),
                                ("conv", ch, 1), ("conv_bias", ch, 0),
                                ("out_proj", di, 0)):
            w = getattr(p, name)
            setattr(self, name, w if w.shape[dim] == full
                    else all_gather(w, mesh, dim=dim, mean=True))
        for name in ("dt_bias", "A_log", "D", "norm"):
            setattr(self, name, getattr(p, name))


def ssm_block(p: SSM, u: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict] = None, mesh=None, inplace: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba2 block.  u: [B, S, d].  With ``cache`` and S == 1: decode step.

    cache = {"conv": [B, Kw-1, Ch], "state": [B, H, P, N]}.  A decode step
    returns new cache tensors, or, with ``inplace``, writes them into the
    given ones (``copy_``) and returns that cache.  Under a ``model`` axis
    the caches take the reference's layout (``launch.partition.
    cache_specs``): ``state`` split by heads where H divides ``model``,
    ``conv`` by channels where Ch does, each on its own (``_local_cache``).
    """
    B, S, d = u.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    p = _Leaves(p, cfg, mesh)
    zxbcdt = torch.matmul(u, p.in_proj)
    z, xr, Bm, Cm, dtr = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xr, Bm, Cm], dim=-1)

    if cache is not None and S == 1:
        # ---- decode: O(1) state update --------------------------------------
        conv_c, state = cache["conv"], cache["state"]
        # every rank runs the whole block: gather each split leaf whole
        split_conv = conv_c.shape[2] < di + 2 * N
        split_state = state.shape[1] < H
        if split_conv:
            conv_c = all_gather(conv_c, mesh, dim=2)
        if split_state:
            state = all_gather(state, mesh, dim=1)
        window = torch.cat([conv_c, xbc], dim=1)                     # [B,Kw,Ch]
        conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv.float())
        conv_out = F.silu(conv_out + p.conv_bias.float())
        xr1 = conv_out[:, :di].reshape(B, H, Pd)
        Bm1 = conv_out[:, di:di + N]
        Cm1 = conv_out[:, di + N:]
        dt1 = F.softplus(dtr[:, 0].float() + p.dt_bias)              # [B,H]
        a = torch.exp(-torch.exp(p.A_log)[None] * dt1)                # [B,H]
        h = a[:, :, None, None] * state + torch.einsum(
            "bh,bhp,bn->bhpn", dt1, xr1, Bm1)
        y = torch.einsum("bn,bhpn->bhp", Cm1, h)
        y = y + p.D[None, :, None] * xr1
        y = y.reshape(B, 1, di) * F.silu(z.float())
        y = rms_norm(y.to(u.dtype), p.norm, cfg.norm_eps)
        out = torch.matmul(y, p.out_proj)
        conv_c = window[:, 1:]
        i, n = axis_index(mesh), axis_size(mesh)
        if split_conv:
            conv_c = conv_c.chunk(n, dim=2)[i]
        if split_state:
            h = h.chunk(n, dim=1)[i]
        if inplace:
            cache["conv"].copy_(conv_c)
            cache["state"].copy_(h)
            return out, cache
        return out, {"conv": conv_c, "state": h}

    # ---- full sequence -------------------------------------------------------
    xbc = _causal_conv(xbc, p.conv, p.conv_bias)
    xr = xbc[..., :di].reshape(B, S, H, Pd)
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]
    dtf = F.softplus(dtr.float() + p.dt_bias)
    y, h_fin = ssd_chunked(xr, dtf, p.A_log, Bm, Cm, cfg)
    y = y.reshape(B, S, di).float() + (p.D[None, None, :, None]
                                       * xr.float()).reshape(B, S, di)
    y = y * F.silu(z.float())
    y = rms_norm(y.to(u.dtype), p.norm, cfg.norm_eps)
    out = torch.matmul(y, p.out_proj)
    new_cache = None
    if cache is not None:
        new_cache = _local_cache(
            {"conv": xbc_tail(u, p, cfg, cfg.ssm_conv), "state": h_fin}, cfg,
            mesh)
    return out, new_cache


def _local_cache(cache: Dict, cfg: ModelConfig, mesh) -> Dict:
    """A whole SSM cache cut to this rank's share of ``cache_specs``'
    layout: ``state`` by heads where H divides ``model``, ``conv`` by
    channels where Ch does (no split without a ``model`` axis)."""
    n, i = axis_size(mesh), axis_index(mesh)
    if n == 1:
        return cache
    out = dict(cache)
    if div_or_none(cfg.ssm_heads, "model", mesh) is not None:
        out["state"] = cache["state"].chunk(n, dim=1)[i].contiguous()
    if div_or_none(cfg.d_inner + 2 * cfg.ssm_state, "model", mesh) is not None:
        out["conv"] = cache["conv"].chunk(n, dim=2)[i].contiguous()
    return out


def xbc_tail(u, p: SSM, cfg: ModelConfig, Kw: int):
    """Last Kw-1 pre-conv features (for seeding a decode cache after
    prefill); a prompt shorter than Kw-1 gives all of its rows, as in the
    reference, and a decode step on that cache then fails on the shape."""
    zxbcdt = torch.matmul(u[:, -(Kw - 1):], p.in_proj)
    _, xr, Bm, Cm, _ = _split_proj(cfg, zxbcdt)
    return torch.cat([xr, Bm, Cm], dim=-1)


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device="cuda") -> Dict:
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, Pd, N), device=device),
    }
