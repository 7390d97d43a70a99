"""Transformer substrate: GQA attention (flash-chunked), MLPs, MoE.

Port of ``repro.models.layers``.  Attention runs the reference's two-level
chunked online softmax, so the [S, S] score matrix never materializes.
MoE keeps the reference's two lowerings:

  * ``moe_dense``: sort/scatter top-k dispatch — what a call without a mesh
    runs (the serve loop's prefill);
  * ``moe_a2a``: the reference's expert-parallel dispatch, which sums the
    expert outputs in f32 — what ``moe_impl="a2a"`` configs run under a
    mesh.  With ``model > 1`` the sequence is split over ``model``, each
    rank routes its own tokens, and two ``all_to_all``s move the capacity
    buffers to the experts' ranks and back.

Tensor parallelism over ``model`` (a bound ``launch.mesh.DeviceMesh``;
each rank's module holds its slices, ``launch.partition``): attention is
split by heads (``wq``/``wk``/``wv`` by columns, ``wo`` by rows through
``row_parallel_matmul``), the MLP by ``up``/``gate`` columns and ``down``
rows, the experts over ``model``.  A leaf whose slice does not fall on whole
heads is gathered before use (``sharding.all_gather``).  Whether a leaf is
split is read off its shape against the config's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .common import ACTIVATIONS, apply_rope, dense_init_, param
from .config import ModelConfig
from .sharding import (
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    copy_to,
    gather_seq,
    reduce_,
    reduce_from,
    scatter_seq,
)
from . import tripcount


# =============================================================================
# row-parallel matmul (the bf16 wire of the reference's §Perf hillclimb B)
# =============================================================================

class _RowParallelBF16(torch.autograd.Function):
    """Partial products cross ranks in bf16; the backward runs no
    collective (dy is the same on every rank, so dh = dy w^T is this rank's
    slice and dw = h^T dy is shard-local), as the reference's custom VJP."""

    @staticmethod
    def forward(ctx, h, w, mesh):
        ctx.save_for_backward(h, w)
        part = torch.matmul(h.float(), w.float())
        return reduce_(part.to(torch.bfloat16), mesh).to(h.dtype)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        dh = torch.matmul(dy, w.to(dy.dtype).T).to(h.dtype)
        dw = torch.matmul(h.reshape(-1, h.shape[-1]).float().T,
                          dy.reshape(-1, dy.shape[-1]).float()).to(w.dtype)
        return dh, dw, None


def row_parallel_matmul(h: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
                        mesh=None) -> torch.Tensor:
    """y[B,S,d] = h[B,S,n] @ w[n,d] with n split over ``model``: the
    partial products are summed over ``model`` in f32, or in bf16 with
    ``cfg.bf16_reduce``.  Without a ``model`` axis, the plain product."""
    if axis_size(mesh) == 1:
        return torch.matmul(h, w)
    if cfg.bf16_reduce:
        return _RowParallelBF16.apply(h, w, mesh)
    return reduce_from(torch.matmul(h, w).float(), mesh).to(h.dtype)


# =============================================================================
# int8 KV cache
# =============================================================================

def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x [B,S,K,hd] -> (int8, f32 scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


# =============================================================================
# Attention
# =============================================================================

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = param((d, H * hd), device, dtype)
        self.wk = param((d, K * hd), device, dtype)
        self.wv = param((d, K * hd), device, dtype)
        self.wo = param((H * hd, d), device, dtype)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)


def _heads(p: Attention, cfg: ModelConfig, mesh):
    """This rank's share of the heads: (wq, wk, wv, wo, H, K, split).

    ``split``: the q heads are split over ``model`` (``wq`` by columns on
    whole heads, so each GQA group stays on one rank); then ``wk``/``wv``
    are this rank's kv heads, or the columns of the kv heads its q heads
    read, cut from the gathered (split off whole heads) or replicated leaf.
    Otherwise every leaf split over ``model`` is gathered and every rank
    runs all heads."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tpn = axis_size(mesh)
    G = H // K
    Hl = p.wq.shape[1] // hd
    split = (tpn > 1 and p.wq.shape[1] < H * hd and p.wq.shape[1] % hd == 0
             and (Hl % G == 0 or G % Hl == 0))
    if not split:
        ws = [w if w.shape == full else all_gather(
                  w, mesh, dim=int(w.shape[0] == full[0]), mean=True)
              for w, full in ((p.wq, (p.wq.shape[0], H * hd)),
                              (p.wk, (p.wk.shape[0], K * hd)),
                              (p.wv, (p.wv.shape[0], K * hd)),
                              (p.wo, (H * hd, p.wo.shape[1])))]
        return (*ws, H, K, False)
    Kl = max(1, Hl // G)
    k0 = axis_index(mesh) * Hl // G
    kv = []
    for w in (p.wk, p.wv):
        if w.shape[1] == Kl * hd and w.shape[1] < K * hd \
                and axis_index(mesh) * Kl == k0:
            kv.append(w)
            continue
        full = all_gather(w, mesh, dim=1) if w.shape[1] < K * hd \
            else copy_to(w, mesh)
        kv.append(full[:, k0 * hd:(k0 + Kl) * hd])
    return p.wq, kv[0], kv[1], p.wo, Hl, Kl, True


def _flash(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0):
    """Two-level chunked attention with online softmax.

    q: [B, Sq, K, G, hd]; k, v: [B, Sk, K, hd].  Returns [B, Sq, K, G, hd].
    Scores are computed blockwise in f32; the live score block is
    [B, K, G, cq, ck].  Padded keys and (causally) future keys are masked
    to -inf, and a row with no visible key yet is guarded, as in the
    reference.
    """
    B, Sq, K, G, hd = q.shape
    Sk = k.shape[1]
    Sq_orig, Sk_orig = Sq, Sk
    cq = min(chunk, Sq)
    ck = min(chunk, Sk)
    if Sq % cq:
        pad = cq - Sq % cq
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        Sq += pad
    if Sk % ck:
        pad = ck - Sk % ck
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        Sk += pad
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    kf, vf = k.float(), v.float()
    outs = []
    for iq in tripcount.trips(Sq // cq):
        qi = q[:, iq * cq:(iq + 1) * cq].float()
        m = torch.full((B, K, G, cq), -torch.inf, device=dev)
        l = torch.zeros((B, K, G, cq), device=dev)
        acc = torch.zeros((B, cq, K, G, hd), device=dev)
        for jk in tripcount.trips(Sk // ck):
            kj = kf[:, jk * ck:(jk + 1) * ck]
            vj = vf[:, jk * ck:(jk + 1) * ck]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj) * scale
            kpos = jk * ck + torch.arange(ck, device=dev)
            if causal:
                qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
                mask = (qpos[:, None] >= kpos[None, :]) & (kpos < Sk_orig)[None]
                s = torch.where(mask, s, -torch.inf)
            elif Sk != Sk_orig:
                s = torch.where(kpos < Sk_orig, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (m_new == -inf)
            new_inf, old_inf = torch.isinf(m_new), torch.isinf(m)
            m_safe = torch.where(new_inf, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(new_inf[..., None], 0.0, p)
            corr = torch.exp(torch.where(old_inf, 0.0, m) - m_safe)
            corr = torch.where(old_inf, torch.where(new_inf, 1.0, 0.0), corr)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bqkgh", p, vj)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        lsafe = torch.clamp(l, min=1e-20)
        outs.append((acc / lsafe.permute(0, 3, 1, 2)[..., None]).to(q.dtype))
    return torch.cat(tripcount.full(outs, Sq // cq), dim=1)[:, :Sq_orig]


def attention(
    p: Attention,
    x: torch.Tensor,                  # [B, S, d]
    positions: torch.Tensor,          # [B, S]
    cfg: ModelConfig,
    causal: bool = True,
    cache: Optional[Dict] = None,     # {"k": [B, S, K, hd], "v": ..., "pos": int32}
    kv_from: Optional[torch.Tensor] = None,  # cross-attention source [B, Skv, d]
    cross: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  With ``cache`` and S == 1 runs one decode step.

    ``cross=True`` marks cross-attention: no rope, never causal, and the KV
    pair comes from ``kv_from`` (or from a *static* cache {"k", "v"}
    computed once from the encoder output).  Returns (output [B, S, d],
    cache or None).  A decode step writes its key and value at
    ``min(pos, window - 1)`` — the clamp of the reference's
    ``dynamic_update_slice``, so a step at ``pos >= window`` overwrites the
    last slot — and attends to the slots ``<= pos``.  Caches are not
    modified; the step returns new ones.  Under a ``model`` axis each rank
    runs its heads (``_heads``), and the caches of a prefill hold those
    heads; a decode step takes the reference's layout, the window split
    over ``model`` (``_decode_split``).
    """
    B, S, d = x.shape
    hd = cfg.hd
    if cache is not None and S == 1 and axis_size(mesh) > 1 \
            and ("pos" in cache or (cross and "k" in cache)):
        return _decode_split(p, x, positions, cfg, cache, cross, mesh)
    wq, wk, wv, wo, H, K, split = _heads(p, cfg, mesh)
    G = H // K
    if split:
        x = copy_to(x, mesh)
        kv_from = None if kv_from is None else copy_to(kv_from, mesh)

    def out_proj(o):
        if split:
            return row_parallel_matmul(o, wo, cfg, mesh)
        return torch.matmul(o, wo)

    q = torch.matmul(x, wq).reshape(B, S, H, hd)
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta)

    if cross and cache is not None and "k" in cache:
        k, v = cache["k"], cache["v"]          # static source cache
    else:
        kv_src = x if kv_from is None else kv_from
        Skv = kv_src.shape[1]
        k = torch.matmul(kv_src, wk).reshape(B, Skv, K, hd)
        v = torch.matmul(kv_src, wv).reshape(B, Skv, K, hd)
        if not cross:
            kpos = positions if S == Skv else positions[:, -Skv:]
            k = apply_rope(k, kpos, cfg.rope_theta)

    if not cross and cache is not None and "pos" in cache and S == 1:
        # ---- self-attention decode: write the cache, attend over window ----
        pos = cache["pos"]
        span = cache["k"].shape[1]
        slot = pos.clamp(0, span - 1).reshape(1).long()
        quant = "k_scale" in cache
        if quant:
            k8, ks = kv_quantize(k)
            v8, vs = kv_quantize(v)
            ck = cache["k"].index_copy(1, slot, k8)
            cv = cache["v"].index_copy(1, slot, v8)
            cks = cache["k_scale"].index_copy(1, slot, ks)
            cvs = cache["v_scale"].index_copy(1, slot, vs)
            # fold the scales outside the int8 products, as the reference
            s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                             ck.float())
            s = s * cks[..., 0].permute(0, 2, 1)[:, :, None, None, :]
            s = s / np.sqrt(hd)
        else:
            ck = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
            cv = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))
            s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                             ck.float()) / np.sqrt(hd)
        valid = torch.arange(span, device=x.device) <= pos
        s = torch.where(valid, s, -torch.inf)
        pr = torch.softmax(s, dim=-1)
        if quant:
            pr = pr * cvs[..., 0].permute(0, 2, 1)[:, :, None, None, :]
        o = torch.einsum("bkgqs,bskh->bqkgh", pr, cv.float())
        o = o.to(x.dtype).reshape(B, 1, H * hd)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}
        if quant:
            new_cache.update(k_scale=cks, v_scale=cvs)
        return out_proj(o), new_cache

    if cross and S == 1:
        # ---- cross-attention decode against the static source cache --------
        s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                         k.float()) / np.sqrt(hd)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr, v.float())
        o = o.to(x.dtype).reshape(B, 1, H * hd)
        return out_proj(o), cache

    # ---- full attention (train / prefill) ----------------------------------
    o = _flash(q.reshape(B, S, K, G, hd), k, v, causal=causal and not cross,
               chunk=cfg.attn_chunk)
    out = out_proj(o.reshape(B, S, H * hd))
    out_cache = None
    if cache is not None and not cross:
        pos = torch.tensor(S, dtype=torch.int32, device=x.device)
        if cfg.kv_quant:
            k8, ks = kv_quantize(k)
            v8, vs = kv_quantize(v)
            out_cache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs,
                         "pos": pos}
        else:
            out_cache = {"k": k, "v": v, "pos": pos}
    elif cache is not None:
        out_cache = {"k": k, "v": v}
    return out, out_cache


def _decode_split(p: Attention, x, positions, cfg: ModelConfig, cache: Dict,
                  cross: bool, mesh):
    """One decode step under a ``model`` axis on the reference's cache
    layout (``launch.partition.cache_specs``): each rank holds a slice of
    the window (of the source, for a cross-attention cache) for every kv
    head.  The step's q, k and v columns are gathered whole, the rank whose
    slice holds the write slot writes it, and each rank attends over its
    slice; the softmax's max, sum and weighted values are reduced over
    ``model``, and ``wo``'s row split sums the output as in training."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // K

    def cols(w, n):
        y = torch.matmul(x, w)
        return y if w.shape[1] == n else all_gather(y, mesh, dim=-1)

    q = cols(p.wq, H * hd).reshape(B, 1, H, hd)
    span = cache["k"].shape[1]
    lo = axis_index(mesh) * span
    quant = "k_scale" in cache
    if cross:
        valid = None
        ck, cv = cache["k"], cache["v"]
        new_cache = cache
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(cols(p.wk, K * hd).reshape(B, 1, K, hd), positions,
                       cfg.rope_theta)
        v = cols(p.wv, K * hd).reshape(B, 1, K, hd)
        pos = cache["pos"]
        local = pos.clamp(0, span * axis_size(mesh) - 1).reshape(1).long() - lo
        here = (local >= 0) & (local < span)
        idx = local.clamp(0, span - 1)

        def write(buf, val):
            old = buf.index_select(1, idx)
            return buf.index_copy(1, idx, torch.where(here, val.to(buf.dtype),
                                                      old))

        if quant:
            k8, ks = kv_quantize(k)
            v8, vs = kv_quantize(v)
            ck, cv = write(cache["k"], k8), write(cache["v"], v8)
            new_cache = {"k": ck, "v": cv,
                         "k_scale": write(cache["k_scale"], ks),
                         "v_scale": write(cache["v_scale"], vs),
                         "pos": pos + 1}
        else:
            ck, cv = write(cache["k"], k), write(cache["v"], v)
            new_cache = {"k": ck, "v": cv, "pos": pos + 1}
        valid = lo + torch.arange(span, device=x.device) <= pos
    s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                     ck.float())
    if quant:
        s = s * new_cache["k_scale"][..., 0].permute(0, 2, 1)[:, :, None,
                                                               None, :]
    s = s / np.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, -torch.inf)
    m = reduce_(s.amax(-1, keepdim=True), mesh, op=dist.ReduceOp.MAX)
    pr = torch.exp(s - m)
    den = reduce_from(pr.sum(-1), mesh)                                # [B,K,G,1]
    if quant:
        pr = pr * new_cache["v_scale"][..., 0].permute(0, 2, 1)[:, :, None,
                                                                None, :]
    o = reduce_from(torch.einsum("bkgqs,bskh->bqkgh", pr, cv.float()), mesh)
    o = (o / den.permute(0, 3, 1, 2)[..., None]).to(x.dtype).reshape(
        B, 1, H * hd)
    if p.wo.shape[0] < H * hd:
        r0 = axis_index(mesh) * p.wo.shape[0]
        out = row_parallel_matmul(o[..., r0:r0 + p.wo.shape[0]], p.wo, cfg,
                                  mesh)
    else:
        out = torch.matmul(o, p.wo)
    return out, new_cache


def make_cache(cfg: ModelConfig, batch: int, length: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    K, hd = cfg.n_kv_heads, cfg.hd
    pos = torch.tensor(0, dtype=torch.int32, device=device)
    if cfg.kv_quant:
        return {
            "k": torch.zeros((batch, length, K, hd), dtype=torch.int8, device=device),
            "v": torch.zeros((batch, length, K, hd), dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, length, K, 1), device=device),
            "v_scale": torch.zeros((batch, length, K, 1), device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros((batch, length, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, K, hd), dtype=dtype, device=device),
        "pos": pos,
    }


# =============================================================================
# Dense MLP
# =============================================================================

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.d_ff = f
        self.up = param((d, f), device, dtype)
        self.down = param((f, d), device, dtype)
        if cfg.activation == "swiglu":
            self.gate = param((d, f), device, dtype)
        else:
            self.register_parameter("gate", None)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.up, self.down, self.gate):
            if w is not None:
                dense_init_(w, gen)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """``down(act(up(x)))``; with ``up``/``gate`` split by columns over
    ``model`` (and ``down`` by rows), a row-parallel product."""
    split = p.up.shape[1] < p.d_ff
    if split:
        x = copy_to(x, mesh)
    up = torch.matmul(x, p.up)
    if cfg.activation == "swiglu":
        h = F.silu(torch.matmul(x, p.gate)) * up
    else:
        h = ACTIVATIONS[cfg.activation](up)
    if split:
        return row_parallel_matmul(h, p.down, cfg, mesh)
    return torch.matmul(h, p.down)


# =============================================================================
# Mixture of Experts
# =============================================================================

class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param((d, E), device, torch.float32)
        self.up = param((E, d, f), device, dtype)
        self.down = param((E, f, d), device, dtype)
        if cfg.activation == "swiglu":
            self.gate = param((E, d, f), device, dtype)
        else:
            self.register_parameter("gate", None)
        self.shared = None
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device, dtype,
                              d_ff=cfg.n_shared_experts * cfg.d_ff)

    def init_(self, gen: torch.Generator) -> None:
        dense_init_(self.router, gen)
        for w in (self.up, self.down, self.gate):
            if w is not None:
                dense_init_(w, gen, in_axis=1)
        if self.shared is not None:
            self.shared.init_(gen)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(np.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _route(p: MoE, xf: torch.Tensor, cfg: ModelConfig, router=None):
    """Router: returns (gates [T,k], experts [T,k], aux_loss scalar).

    ``torch.topk`` and ``jax.lax.top_k`` may order equal probabilities
    differently; the parity tests compare the chosen experts exactly."""
    logits = torch.matmul(xf.float(), p.router if router is None else router)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    # Switch-style load-balance loss
    E = cfg.n_experts
    me = probs.mean(0)                                              # [E]
    ce = F.one_hot(eids[:, 0], E).float().mean(0)
    aux = E * (me * ce).sum()
    return gates, eids, aux


def _expert_ffn(p: MoE, xg: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xg: [E, C, d] -> [E, C, d] through each expert's FFN (this rank's
    experts, when they are split over ``model``)."""
    up = torch.bmm(xg, p.up)
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(xg, p.gate)) * up
    else:
        h = ACTIVATIONS[cfg.activation](up)
    return torch.bmm(h, p.down)


def _slots(p: MoE, xf: torch.Tensor, cfg: ModelConfig, router=None):
    """Top-k routing into capacity slots.

    Stable argsort over the chosen experts, rank within the expert by
    ``searchsorted(side="left")``, overflow beyond capacity C sent to the
    drop bin at E*C.  Returns (xg [E, C, d], slot [T*k], gate of each
    [T*k], token of each [T*k], aux) in expert-sorted order."""
    T, d = xf.shape
    gates, eids, aux = _route(p, xf, cfg, router)
    k, E = cfg.top_k, cfg.n_experts
    C = _capacity(T, cfg)
    flat_e = eids.reshape(-1)                                       # [T*k]
    sidx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sidx]
    first_occ = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T * k, device=xf.device) - first_occ
    slot = torch.where(rank < C, sorted_e * C + rank, E * C)        # E*C = drop bin
    tok = sidx // k
    xg = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    xg[slot] = xf[tok]
    return xg[:-1].reshape(E, C, d), slot, gates.reshape(-1)[sidx], tok, aux


def _unslot(yg: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[E, C, d] expert outputs -> one row per (token, choice) in
    expert-sorted order; the drop bin's row is zero."""
    E, C, d = yg.shape
    return torch.cat([yg.reshape(E * C, d), yg.new_zeros((1, d))])[slot]


def _local_experts(p: MoE, xg: torch.Tensor, cfg: ModelConfig, mesh):
    """All experts' slots computed where their weights are: this rank's
    experts, the others' rows zero (a partial to sum over ``model``)."""
    El = p.up.shape[0]
    e0 = axis_index(mesh) * El
    E, C, d = xg.shape
    yl = _expert_ffn(p, xg[e0:e0 + El], cfg)
    return torch.cat([yl.new_zeros((e0, C, d)), yl,
                      yl.new_zeros((E - e0 - El, C, d))])


def moe_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """Sort/scatter top-k dispatch; overflow beyond expert capacity is
    dropped (standard capacity-factor semantics).  The gated outputs are
    summed per token in the activations' dtype.  With the experts split
    over ``model``, every rank routes every token, runs its own experts and
    the partial outputs are summed over ``model``."""
    B, S, d = x.shape
    T = B * S
    split = p.up.shape[0] < cfg.n_experts
    xs = copy_to(x, mesh) if split else x
    router = copy_to(p.router, mesh) if split else p.router
    xg, slot, gsel, tok, aux = _slots(p, xs.reshape(T, d), cfg, router)
    yg = _local_experts(p, xg, cfg, mesh) if split else _expert_ffn(p, xg, cfg)
    y_sorted = _unslot(yg, slot)
    contrib = y_sorted * gsel[:, None].to(y_sorted.dtype)
    y = torch.zeros((T, d), dtype=contrib.dtype, device=x.device)
    y = y.index_add_(0, tok, contrib)
    if split:
        y = reduce_from(y, mesh)
        aux = reduce_from(aux, mesh) / axis_size(mesh)
    y = y.to(x.dtype)
    if p.shared is not None:
        y = y + mlp(p.shared, x, cfg, mesh).reshape(T, d)
    return y.reshape(B, S, d), aux


def _combine(y_sorted, gsel, tok, T: int) -> torch.Tensor:
    """The gated outputs summed per token in f32."""
    y = torch.zeros((T, y_sorted.shape[1]), dtype=torch.float32,
                    device=y_sorted.device)
    return y.index_add_(0, tok, y_sorted.float() * gsel[:, None])


def moe_a2a(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The reference's expert-parallel dispatch, its gated outputs summed
    per token in f32.

    ``mesh`` has a ``model`` axis of ``ep`` ranks (the serving loop's 1x1
    engine ``Mesh`` has one); the experts are split over it.  Each rank
    routes its own slice of the sequence (capacity from its own token
    count), ``all_to_all`` sends each expert's slots ``[E, C, d] -> [E/ep,
    ep*C, d]`` to the expert's rank and back, and the sequence is gathered
    again for the next block.  A sequence that does not split over ``ep``
    (a decode step) is routed on every rank, each running its own experts,
    and the partial outputs are summed.  The aux loss is averaged over
    ``model`` (the train step averages over the data axes)."""
    ep = axis_size(mesh)
    B, S, d = x.shape
    if ep == 1:
        T = B * S
        xg, slot, gsel, tok, aux = _slots(p, x.reshape(T, d), cfg)
        y = _combine(_unslot(_expert_ffn(p, xg, cfg), slot), gsel, tok, T)
        y = y.to(x.dtype).reshape(B, S, d)
    else:
        E, El = cfg.n_experts, p.up.shape[0]
        if El * ep != E:
            raise ValueError(f"moe_a2a splits {E} experts over model = {ep}: "
                             f"it needs a split leaf of E / model experts, "
                             f"got {El}")
        router = copy_to(p.router, mesh)
        if S % ep == 0 and S >= ep:
            xl = scatter_seq(x, mesh, dim=1)                  # [B, S/ep, d]
            T = xl.shape[0] * xl.shape[1]
            xg, slot, gsel, tok, aux = _slots(p, xl.reshape(T, d), cfg,
                                              router)
            C = xg.shape[1]
            # [E, C, d] -a2a-> [E/ep, ep*C, d]: this rank's experts' slots
            xe = all_to_all(xg, mesh).view(ep, El, C, d).transpose(0, 1)
            ye = _expert_ffn(p, xe.reshape(El, ep * C, d), cfg)
            # reverse: [E/ep, ep*C, d] -a2a-> [E, C, d]
            yg = all_to_all(ye.view(El, ep, C, d).transpose(0, 1)
                            .contiguous(), mesh).view(E, C, d)
            y = _combine(_unslot(yg, slot), gsel, tok, T)
            y = gather_seq(y.to(x.dtype).reshape(xl.shape), mesh, dim=1)
        else:
            T = B * S
            xg, slot, gsel, tok, aux = _slots(
                p, copy_to(x, mesh).reshape(T, d), cfg, router)
            y = _combine(_unslot(_local_experts(p, xg, cfg, mesh), slot),
                         gsel, tok, T)
            y = reduce_from(y, mesh).to(x.dtype).reshape(B, S, d)
        aux = reduce_from(aux, mesh) / ep
    if p.shared is not None:
        y = y + mlp(p.shared, x, cfg, mesh)
    return y, aux


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    if cfg.moe_impl == "a2a" and mesh is not None:
        return moe_a2a(p, x, cfg, mesh)
    return moe_dense(p, x, cfg, mesh)
