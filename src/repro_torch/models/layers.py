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
    div_or_none,
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
    inplace: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  With ``cache`` and S == 1 runs one decode step.

    ``cross=True`` marks cross-attention: no rope, never causal, and the KV
    pair comes from ``kv_from`` (or from a *static* cache {"k", "v"}
    computed once from the encoder output).  Returns (output [B, S, d],
    cache or None).  A decode step writes its key and value at
    ``min(pos, window - 1)`` — the clamp of the reference's
    ``dynamic_update_slice``, so a step at ``pos >= window`` overwrites the
    last slot — and attends to the slots ``<= pos``.  Caches are not
    modified; the step returns new ones.  With ``inplace`` the step writes
    its slot into the given cache (``index_copy_``), advances its ``pos``
    in place and returns that cache: no step copies a window.

    Under a ``model`` axis each rank runs its heads (``_heads``); a
    prefill's caches come back in the reference's layout
    (``launch.partition.cache_specs``: every kv head, the window split over
    ``model`` where it divides, ``_prefill_layout``), and a decode step
    takes that layout, split or whole (``_decode_split``).
    """
    B, S, d = x.shape
    hd = cfg.hd
    if cache is not None and S == 1 and axis_size(mesh) > 1 \
            and ("pos" in cache or (cross and "k" in cache)):
        return _decode_split(p, x, positions, cfg, cache, cross, mesh,
                             inplace)
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
        valid = torch.arange(span, device=x.device) <= pos
        quant = "k_scale" in cache
        if quant:
            k8, ks = kv_quantize(k)
            v8, vs = kv_quantize(v)
            vals = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
        else:
            vals = {"k": k, "v": v}
        new_cache = _write_slot(cache, vals, slot, inplace)
        ck, cv = new_cache["k"], new_cache["v"]
        s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                         ck.float())
        if quant:
            # fold the scales outside the int8 products, as the reference
            s = s * new_cache["k_scale"][..., 0].permute(0, 2, 1)[
                :, :, None, None, :]
        s = s / np.sqrt(hd)
        s = torch.where(valid, s, -torch.inf)
        pr = torch.softmax(s, dim=-1)
        if quant:
            pr = pr * new_cache["v_scale"][..., 0].permute(0, 2, 1)[
                :, :, None, None, :]
        o = torch.einsum("bkgqs,bskh->bqkgh", pr, cv.float())
        o = o.to(x.dtype).reshape(B, 1, H * hd)
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
        if axis_size(mesh) > 1:
            G0 = cfg.n_heads // cfg.n_kv_heads
            starts = ([j * H // G0 for j in range(axis_size(mesh))]
                      if split else None)
            out_cache = _prefill_layout(out_cache, cfg, mesh, starts)
    elif cache is not None:
        out_cache = {"k": k, "v": v}
    return out, out_cache


def _write_slot(cache: Dict, vals: Dict, slot: torch.Tensor, inplace: bool,
                here: Optional[torch.Tensor] = None) -> Dict:
    """``cache`` with ``vals`` (each [B, 1, ...], cast to the cache's
    dtypes) written at window index ``slot``: a new dict of new tensors and
    ``pos + 1``, or, ``inplace``, the cache itself, written with
    ``index_copy_`` and its ``pos`` advanced in place.  Where ``here`` is
    false the slot keeps its value (a window split over ``model`` whose
    slot another rank holds)."""
    out = dict(cache)
    for key, val in vals.items():
        buf = cache[key]
        val = val.to(buf.dtype)
        if here is not None:
            val = torch.where(here, val, buf.index_select(1, slot))
        out[key] = (buf.index_copy_(1, slot, val) if inplace
                    else buf.index_copy(1, slot, val))
    if inplace:
        cache["pos"].add_(1)
        return cache
    out["pos"] = cache["pos"] + 1
    return out


def _decode_split(p: Attention, x, positions, cfg: ModelConfig, cache: Dict,
                  cross: bool, mesh, inplace: bool = False):
    """One decode step under a ``model`` axis on the reference's cache
    layout (``launch.partition.cache_specs``), whose window is split over
    ``model`` or whole on every rank (``kv_window``).  The step's q, k and
    v columns are gathered whole.  A split window: each rank holds a slice
    of it (of the source, for a cross-attention cache) for every kv head,
    the rank whose slice holds the write slot writes it, each rank attends
    over its slice, and the softmax's max, sum and weighted values are
    reduced over ``model``.  A whole window: every rank writes the slot and
    attends over the whole window.  Either way ``wo``'s row split sums the
    output, as in training."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // K

    def cols(w, n):
        y = torch.matmul(x, w)
        return y if w.shape[1] == n else all_gather(y, mesh, dim=-1)

    q = cols(p.wq, H * hd).reshape(B, 1, H, hd)
    W, split = kv_window(cache, mesh)
    span = cache["k"].shape[1]
    lo = axis_index(mesh) * span if split else 0
    quant = "k_scale" in cache
    valid = None
    new_cache = cache
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(cols(p.wk, K * hd).reshape(B, 1, K, hd), positions,
                       cfg.rope_theta)
        v = cols(p.wv, K * hd).reshape(B, 1, K, hd)
        pos = cache["pos"]
        valid = lo + torch.arange(span, device=x.device) <= pos
        local = pos.clamp(0, W - 1).reshape(1).long() - lo
        here = (local >= 0) & (local < span) if split else None
        if quant:
            k8, ks = kv_quantize(k)
            v8, vs = kv_quantize(v)
            vals = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
        else:
            vals = {"k": k, "v": v}
        new_cache = _write_slot(cache, vals, local.clamp(0, span - 1),
                                inplace, here)
    ck, cv = new_cache["k"], new_cache["v"]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, 1, K, G, hd).float(),
                     ck.float())
    if quant:
        s = s * new_cache["k_scale"][..., 0].permute(0, 2, 1)[:, :, None,
                                                               None, :]
    s = s / np.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, -torch.inf)
    if split:
        m = reduce_(s.amax(-1, keepdim=True), mesh, op=dist.ReduceOp.MAX)
        pr = torch.exp(s - m)
        den = reduce_from(pr.sum(-1), mesh)                            # [B,K,G,1]
    else:
        pr = torch.softmax(s, dim=-1)
    if quant:
        pr = pr * new_cache["v_scale"][..., 0].permute(0, 2, 1)[:, :, None,
                                                                None, :]
    o = torch.einsum("bkgqs,bskh->bqkgh", pr, cv.float())
    if split:
        o = reduce_from(o, mesh) / den.permute(0, 3, 1, 2)[..., None]
    o = o.to(x.dtype).reshape(B, 1, H * hd)
    if p.wo.shape[0] < H * hd:
        r0 = axis_index(mesh) * p.wo.shape[0]
        out = row_parallel_matmul(o[..., r0:r0 + p.wo.shape[0]], p.wo, cfg,
                                  mesh)
    else:
        out = torch.matmul(o, p.wo)
    return out, new_cache


# =============================================================================
# KV caches on a mesh: the window's layout
# =============================================================================

#: the leaves of an attention cache that hold the window (axis -3)
KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def window_leaf(window: int, lead=(), device=None) -> torch.Tensor:
    """The ``"window"`` leaf of a cache dict on a mesh: a tensor of no
    elements, ``[*lead, 0, window]``, whose last dim is the global KV
    window.  It rides with the cache through stacking, indexing and
    ``cache_specs`` (which replicates it), costs no memory, and is read
    from its shape, never its values (so a trace on ``meta`` reads it)."""
    return torch.empty((*lead, 0, window), dtype=torch.int8, device=device)


def kv_window(cache: Dict, mesh) -> Tuple[int, bool]:
    """(global window, whether it is split over ``model``) of an attention
    cache dict (one layer's or stacked) on ``mesh``.

    ``partition.cache_specs`` splits the window over ``model`` where it
    divides, as the reference does; otherwise every rank holds it whole.
    A local span alone cannot tell the two apart (3 slots on model = 2 are
    a whole window of 3 or a split one of 6), so the layout travels with
    the cache as its ``"window"`` leaf (``window_leaf``), which a mesh's
    prefill, ``lm.grow_caches``, ``encdec.make_dec_caches`` and
    ``partition.shard_caches`` add.  A cache without one is taken as split
    only where no other layout gives its span: a span that divides
    ``model`` is never a whole window; any other span raises."""
    span = cache["k"].shape[-3]
    n = axis_size(mesh)
    if "window" in cache:
        W = cache["window"].shape[-1]
    elif span % n == 0:
        W = span * n
    else:
        raise ValueError(
            f"a KV cache of {span} slots on model = {n} is a whole window of "
            f"{span} or a split one of {span * n}: give the cache its "
            f"'window' leaf (partition.shard_caches, a mesh's prefill, "
            f"lm.grow_caches(mesh=...))")
    split = div_or_none(W, "model", mesh) is not None
    if (W // n if split else W) != span:
        raise ValueError(f"a KV cache of {span} slots per rank does not hold "
                         f"its window of {W} on model = {n}")
    return W, split


def mesh_cache(cache: Dict, mesh) -> Dict:
    """A whole attention cache dict (every kv head, the whole window; one
    layer's or stacked) cut to this rank's share of ``cache_specs``'
    layout on ``mesh``: the window split over ``model`` where it divides,
    with its ``"window"`` leaf."""
    k = cache["k"]
    W = k.shape[-3]
    split = div_or_none(W, "model", mesh) is not None
    n, r = axis_size(mesh), axis_index(mesh)
    out = {}
    for key, val in cache.items():
        if key in KV_LEAVES and split:
            val = val.chunk(n, dim=val.ndim - 3)[r].contiguous()
        out[key] = val
    out["window"] = window_leaf(W, k.shape[:-4], k.device)
    return out


def whole_cache(cache: Dict, mesh) -> Dict:
    """The inverse of ``mesh_cache``: a split window gathered over
    ``model``, the ``"window"`` leaf dropped (collective where split)."""
    _, split = kv_window(cache, mesh)
    return {key: (all_gather(val, mesh, dim=val.ndim - 3)
                  if key in KV_LEAVES and split else val)
            for key, val in cache.items() if key != "window"}


def _prefill_layout(cache: Dict, cfg: ModelConfig, mesh, starts) -> Dict:
    """A prefill's cache on a mesh, this rank's kv heads over the whole
    prompt (``starts``: each rank's first kv head; None when every rank
    holds all of them), in ``cache_specs``' layout (``mesh_cache``).  Where
    the ranks hold distinct heads and the window splits, one
    ``all_to_all`` sends each rank's heads of every other rank's window
    slice there; otherwise the heads are gathered and the window cut."""
    K = cfg.n_kv_heads
    n = axis_size(mesh)
    S = cache["k"].shape[1]
    whole = {"pos": cache["pos"]}
    if starts is None:
        whole.update({key: cache[key] for key in cache if key != "pos"})
        return mesh_cache(whole, mesh)
    Kl = cache["k"].shape[2]
    if Kl * n == K and div_or_none(S, "model", mesh) is not None:
        out = dict(whole)
        for key, t in cache.items():
            if key == "pos":
                continue
            B, _, _, e = t.shape
            x = t.reshape(B, n, S // n, Kl, e).permute(1, 0, 2, 3, 4)
            y = all_to_all(x.contiguous(), mesh)   # [n, B, S/n, Kl, e]
            out[key] = y.permute(1, 2, 0, 3, 4).reshape(B, S // n, K, e)
        out["window"] = window_leaf(S, (), cache["k"].device)
        return out
    # rank j's heads start at starts[j]; take each kv head from the first
    # rank that holds it
    idx = [next(j * Kl + h - starts[j] for j in range(n)
                if starts[j] <= h < starts[j] + Kl) for h in range(K)]
    for key, t in cache.items():
        if key != "pos":
            whole[key] = all_gather(t, mesh, dim=2)[:, :, idx]
    return mesh_cache(whole, mesh)


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
