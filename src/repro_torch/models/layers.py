"""Transformer substrate: GQA attention (flash-chunked), MLPs, MoE.

Port of ``repro.models.layers`` for one device.  Attention runs the
reference's two-level chunked online softmax, so the [S, S] score matrix
never materializes.  MoE keeps the reference's two lowerings:

  * ``moe_dense``: sort/scatter top-k dispatch — what a call without a mesh
    runs (the serve loop's prefill);
  * ``moe_a2a``: the one-shard body of the reference's expert-parallel
    dispatch, which sums the expert outputs in f32 — what ``moe_impl="a2a"``
    configs run under a mesh (the serve loop's decode step, which gets a
    1x1 mesh).  The all_to_all across shards waits for the
    tensor-parallel slice, so a mesh with ``model > 1`` raises.

The reference's ``row_parallel_matmul`` is the plain product on one device;
its ``bf16_reduce`` branch (partial sums crossing chips in bf16) waits for
the tensor-parallel slice too, so ``cfg.bf16_reduce`` changes nothing here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import ACTIVATIONS, apply_rope, dense_init_, param
from .config import ModelConfig


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
    for iq in range(Sq // cq):
        qi = q[:, iq * cq:(iq + 1) * cq].float()
        m = torch.full((B, K, G, cq), -torch.inf, device=dev)
        l = torch.zeros((B, K, G, cq), device=dev)
        acc = torch.zeros((B, cq, K, G, hd), device=dev)
        for jk in range(Sk // ck):
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
    return torch.cat(outs, dim=1)[:, :Sq_orig]


def attention(
    p: Attention,
    x: torch.Tensor,                  # [B, S, d]
    positions: torch.Tensor,          # [B, S]
    cfg: ModelConfig,
    causal: bool = True,
    cache: Optional[Dict] = None,     # {"k": [B, S, K, hd], "v": ..., "pos": int32}
    kv_from: Optional[torch.Tensor] = None,  # cross-attention source [B, Skv, d]
    cross: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  With ``cache`` and S == 1 runs one decode step.

    ``cross=True`` marks cross-attention: no rope, never causal, and the KV
    pair comes from ``kv_from`` (or from a *static* cache {"k", "v"}
    computed once from the encoder output).  Returns (output [B, S, d],
    cache or None).  A decode step writes its key and value at
    ``min(pos, window - 1)`` — the clamp of the reference's
    ``dynamic_update_slice``, so a step at ``pos >= window`` overwrites the
    last slot — and attends to the slots ``<= pos``.  Caches are not
    modified; the step returns new ones.
    """
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // K
    q = torch.matmul(x, p.wq).reshape(B, S, H, hd)
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta)

    if cross and cache is not None and "k" in cache:
        k, v = cache["k"], cache["v"]          # static source cache
    else:
        kv_src = x if kv_from is None else kv_from
        Skv = kv_src.shape[1]
        k = torch.matmul(kv_src, p.wk).reshape(B, Skv, K, hd)
        v = torch.matmul(kv_src, p.wv).reshape(B, Skv, K, hd)
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
        return torch.matmul(o, p.wo), new_cache

    if cross and S == 1:
        # ---- cross-attention decode against the static source cache --------
        s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                         k.float()) / np.sqrt(hd)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr, v.float())
        o = o.to(x.dtype).reshape(B, 1, H * hd)
        return torch.matmul(o, p.wo), cache

    # ---- full attention (train / prefill) ----------------------------------
    o = _flash(q.reshape(B, S, K, G, hd), k, v, causal=causal and not cross,
               chunk=cfg.attn_chunk)
    out = torch.matmul(o.reshape(B, S, H * hd), p.wo)
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


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = torch.matmul(x, p.up)
    if cfg.activation == "swiglu":
        h = F.silu(torch.matmul(x, p.gate)) * up
    else:
        h = ACTIVATIONS[cfg.activation](up)
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


def _route(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """Router: returns (gates [T,k], experts [T,k], aux_loss scalar).

    ``torch.topk`` and ``jax.lax.top_k`` may order equal probabilities
    differently; the parity tests compare the chosen experts exactly."""
    logits = torch.matmul(xf.float(), p.router)
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
    """xg: [E, C, d] -> [E, C, d] through each expert's FFN."""
    up = torch.bmm(xg, p.up)
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(xg, p.gate)) * up
    else:
        h = ACTIVATIONS[cfg.activation](up)
    return torch.bmm(h, p.down)


def _dispatch(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """Top-k routing into capacity slots and the experts' outputs, gathered
    back per (token, choice) in expert-sorted order.

    Stable argsort over the chosen experts, rank within the expert by
    ``searchsorted(side="left")``, overflow beyond capacity C sent to the
    drop bin at E*C (whose row is zero on the way back).  Returns
    (y_sorted [T*k, d], gate of each [T*k], token of each [T*k], aux)."""
    T, d = xf.shape
    gates, eids, aux = _route(p, xf, cfg)
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
    yg = _expert_ffn(p, xg[:-1].reshape(E, C, d), cfg)
    y_sorted = torch.cat([yg.reshape(E * C, d), yg.new_zeros((1, d))])[slot]
    return y_sorted, gates.reshape(-1)[sidx], tok, aux


def moe_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Sort/scatter top-k dispatch; overflow beyond expert capacity is
    dropped (standard capacity-factor semantics).  The gated outputs are
    summed per token in the activations' dtype."""
    B, S, d = x.shape
    T = B * S
    y_sorted, gsel, tok, aux = _dispatch(p, x.reshape(T, d), cfg)
    contrib = y_sorted * gsel[:, None].to(y_sorted.dtype)
    y = torch.zeros((T, d), dtype=contrib.dtype, device=x.device)
    y = y.index_add_(0, tok, contrib).to(x.dtype)
    if p.shared is not None:
        y = y + mlp(p.shared, x, cfg).reshape(T, d)
    return y.reshape(B, S, d), aux


def moe_a2a(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The one-shard body of the reference's expert-parallel dispatch: the
    gated outputs are summed per token in f32.  ``mesh`` is the serving
    mesh (anything with a ``model`` axis size); the all_to_all across
    ``model > 1`` shards is not ported yet and raises."""
    if getattr(mesh, "model", 1) != 1:
        raise NotImplementedError(
            "moe_a2a across model shards (the all_to_all) is not ported; "
            "this port runs the one-shard body only")
    B, S, d = x.shape
    T = B * S
    y_sorted, gsel, tok, aux = _dispatch(p, x.reshape(T, d), cfg)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y = y.index_add_(0, tok, y_sorted.float() * gsel[:, None])
    y = y.to(x.dtype).reshape(B, S, d)
    if p.shared is not None:
        y = y + mlp(p.shared, x, cfg)
    return y, aux


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    if cfg.moe_impl == "a2a" and mesh is not None:
        return moe_a2a(p, x, cfg, mesh)
    return moe_dense(p, x, cfg)
