"""Decoder-only LM assembly for all four families: dense, moe, ssm, hybrid.

Port of ``repro.models.lm``.  Layers live in an ``nn.ModuleList`` and
run in a Python loop where the reference scans over stacked parameters.
The hybrid (zamba2) family runs groups of ``attn_period`` Mamba2 layers,
each group followed by one application of a single *shared* attention+MLP
block, then the ``n_layers % attn_period`` tail layers.  In training with
``cfg.remat``, each unit the reference wraps in ``jax.checkpoint`` (one
dense or MoE block, one SSM layer, the hybrid's group and each tail layer)
runs under ``torch.utils.checkpoint``.

Caches keep the reference's stacked layouts, so they compare directly:
``{"attn": {"k", "v": [L, B, S, K, hd], "pos": [L]}}`` (dense, moe),
``{"ssm": {"conv": [L, B, Kw-1, Ch], "state": [L, B, H, P, N]}}`` (ssm),
and ``{"ssm_main": [G, P, ...], "ssm_tail": [tail, ...] or None,
"attn": [G, ...]}`` (hybrid: G groups of P layers).

Under a ``model`` axis (a bound ``launch.mesh.DeviceMesh`` as ``mesh``;
each rank's module holds its slices) the layers run tensor-parallel
(``layers``, ``ssm``); an embedding split by vocabulary looks tokens up in
its rows and sums over ``model``, and its logits stay split, the cross
entropy's max and sum of exponentials reduced over ``model``.  The loss is
the mean over this rank's rows: the train step averages it over the data
axes.

Entry points (the reference's, with the module in place of ``params``):
  init(generator, cfg)                     -> LM on the generator's device
  forward(params, cfg, tokens|embeds, train) -> (h, aux)
  loss_fn(params, cfg, batch, mesh)        -> (loss, metrics)
  prefill(params, cfg, tokens|embeds)      -> (last-token logits, caches)
  decode_step(params, cfg, token, caches, mesh) -> (logits, caches)
  decode_step_(params, cfg, token, caches, mesh) -> logits (caches written
                                              in place: what a CUDA graph
                                              replays, ``launch.steps``)
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import dense_init_, param, rms_norm
from .config import ModelConfig
from .layers import (MLP, Attention, MoE, attention, kv_window, make_cache,
                     mesh_cache, mlp, moe, whole_cache)
from .sharding import (axis_index, axis_size, copy_to, gather_seq, reduce_,
                       reduce_from)
from .ssm import SSM, make_ssm_cache, ssm_block


# =============================================================================
# modules and init
# =============================================================================

class AttnBlock(nn.Module):
    """Pre-norm attention + MLP (or MoE when ``moe``) block."""

    def __init__(self, cfg: ModelConfig, device, dtype, moe_ffn: bool = False):
        super().__init__()
        self.ln1 = param((cfg.d_model,), device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = param((cfg.d_model,), device, dtype)
        if moe_ffn:
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg, device, dtype)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init_(gen)
        (self.moe if hasattr(self, "moe") else self.mlp).init_(gen)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln = param((cfg.d_model,), device, dtype)
        self.ssm = SSM(cfg, device, dtype)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.ln.fill_(1.0)
        self.ssm.init_(gen)


class LM(nn.Module):
    """The reference's parameter tree as modules; ``state_dict`` names are
    its paths with the layer index after ``layers`` (``layers.3.attn.wq``
    is the reference's ``params["layers"]["attn"]["wq"][3]``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=torch.bfloat16):
        super().__init__()
        d, V = cfg.d_model, cfg.vocab
        self.vocab = V
        self.embed = param((V, d), device, dtype)
        self.final_norm = param((d,), device, dtype)
        if cfg.family in ("ssm", "hybrid"):
            layers = [SSMBlock(cfg, device, dtype) for _ in range(cfg.n_layers)]
        else:
            layers = [AttnBlock(cfg, device, dtype, moe_ffn=cfg.family == "moe")
                      for _ in range(cfg.n_layers)]
        self.layers = nn.ModuleList(layers)
        if cfg.tie_embeddings:
            self.register_parameter("unembed", None)
        else:
            self.unembed = param((d, V), device, dtype)
        # zamba2's shared attention+MLP block (one copy, applied every period)
        self.shared_attn = (AttnBlock(cfg, device, dtype)
                            if cfg.family == "hybrid" else None)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        dense_init_(self.embed, gen, in_axis=1)
        self.final_norm.fill_(1.0)
        for block in self.layers:
            block.init_(gen)
        if self.unembed is not None:
            dense_init_(self.unembed, gen)
        if self.shared_attn is not None:
            self.shared_attn.init_(gen)


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=torch.bfloat16) -> LM:
    """Random weights with the reference's distributions (normal /
    sqrt(fan_in), ones for norms, the SSM's own init), drawn from
    ``generator`` on its device.  ``jax.random`` cannot be reproduced, so
    to match the reference carry its weights across with
    ``repro_torch.convert.lm_params_from_numpy``."""
    model = LM(cfg, device=generator.device, dtype=dtype)
    model.init_(generator)
    return model


# =============================================================================
# blocks
# =============================================================================

def _dense_block(p: AttnBlock, h, positions, cfg: ModelConfig, mesh=None,
                 cache=None, inplace=False):
    a, new_cache = attention(p.attn, rms_norm(h, p.ln1, cfg.norm_eps),
                             positions, cfg, causal=True, cache=cache,
                             mesh=mesh, inplace=inplace)
    h = h + a
    aux = torch.zeros((), device=h.device)
    if cfg.family == "moe":
        m, aux = moe(p.moe, rms_norm(h, p.ln2, cfg.norm_eps), cfg, mesh)
    else:
        m = mlp(p.mlp, rms_norm(h, p.ln2, cfg.norm_eps), cfg, mesh)
    return h + m, aux, new_cache


def _ssm_layer(p: SSMBlock, h, cfg: ModelConfig, cache=None, mesh=None,
               inplace=False):
    s, new_cache = ssm_block(p.ssm, rms_norm(h, p.ln, cfg.norm_eps), cfg,
                             cache=cache, mesh=mesh, inplace=inplace)
    return h + s, new_cache


def _shared_attn_block(p: AttnBlock, h, positions, cfg: ModelConfig,
                       cache=None, mesh=None, inplace=False):
    a, new_cache = attention(p.attn, rms_norm(h, p.ln1, cfg.norm_eps),
                             positions, cfg, causal=True, cache=cache,
                             mesh=mesh, inplace=inplace)
    h = h + a
    h = h + mlp(p.mlp, rms_norm(h, p.ln2, cfg.norm_eps), cfg, mesh)
    return h, new_cache


def _groups(cfg: ModelConfig):
    """The hybrid's layout: (groups, period, tail)."""
    period = cfg.attn_period
    return cfg.n_layers // period, period, cfg.n_layers % period


def _stack(caches: List[Dict]) -> Dict:
    """Per-layer cache dicts -> one dict of tensors stacked on axis 0."""
    return {key: torch.stack([c[key] for c in caches]) for key in caches[0]}


def _index(caches: Dict, i) -> Dict:
    return {key: val[i] for key, val in caches.items()}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


# =============================================================================
# forward
# =============================================================================

def embed_tokens(params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Rows of ``embed`` for ``tokens``; an embedding split by vocabulary
    over ``model`` looks up the tokens in its own rows (zeros elsewhere)
    and sums over ``model``."""
    E = params.embed
    tokens = tokens.long()
    if E.shape[0] == params.vocab:
        return E[tokens]
    lo = axis_index(mesh) * E.shape[0]
    mine = (tokens >= lo) & (tokens < lo + E.shape[0])
    rows = E[(tokens - lo).clamp(0, E.shape[0] - 1)]
    return reduce_from(rows * mine[..., None].to(rows.dtype), mesh)


def _maybe_remat(fn: Callable, cfg: ModelConfig, train: bool) -> Callable:
    """``fn`` recomputed in the backward pass when training with remat (the
    reference's ``jax.checkpoint``).  The models draw no random numbers
    outside ``init``, so the recompute has no RNG state to restore
    (``preserve_rng_state=False``), and a CUDA graph of the train step
    reads none."""
    if train and cfg.remat:
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        preserve_rng_state=False)
    return fn


def forward(params: LM, cfg: ModelConfig, tokens=None, embeds=None, mesh=None,
            train: bool = False):
    """Full-sequence forward (no caches): (final-normed h [B, S, d], aux)."""
    h = embed_tokens(params, tokens, mesh) if embeds is None else embeds
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)
    aux = torch.zeros((), device=h.device)
    layer = _maybe_remat(lambda p, hh: _ssm_layer(p, hh, cfg, mesh=mesh)[0],
                         cfg, train)
    if cfg.family in ("dense", "moe"):
        block = _maybe_remat(
            lambda p, hh: _dense_block(p, hh, positions, cfg, mesh)[:2],
            cfg, train)
        for p in params.layers:
            h, a = block(p, h)
            aux = aux + a
    elif cfg.family == "ssm":
        for p in params.layers:
            h = layer(p, h)
    else:
        G, P, tail = _groups(cfg)

        def group(g, hh):
            for j in range(P):
                hh = _ssm_layer(params.layers[g * P + j], hh, cfg,
                                mesh=mesh)[0]
            return _shared_attn_block(params.shared_attn, hh, positions, cfg,
                                      mesh=mesh)[0]

        group = _maybe_remat(group, cfg, train)
        for g in range(G):
            h = group(g, h)
        for j in range(tail):
            h = layer(params.layers[G * P + j], h)
    return rms_norm(h, params.final_norm, cfg.norm_eps), aux


def unembed_matrix(params) -> torch.Tensor:
    if params.unembed is not None:
        return params.unembed                          # [d, V]
    return params.embed.T                              # tied


def _vocab_split(params) -> bool:
    return unembed_matrix(params).shape[1] < params.vocab


def _logits(params, h, mesh=None) -> torch.Tensor:
    """f32 logits of h [..., d] (the reference's f32-accumulated product);
    a vocabulary split over ``model`` is gathered."""
    if not _vocab_split(params):
        return torch.matmul(h.float(), unembed_matrix(params).float())
    local = torch.matmul(copy_to(h, mesh).float(),
                         unembed_matrix(params).float())
    return gather_seq(local, mesh, dim=-1)


def lm_loss_from_h(params, cfg: ModelConfig, h, labels, mesh=None
                   ) -> torch.Tensor:
    """Mean cross entropy: logsumexp of the f32 logits minus the label's
    logit, taken from the label's unembedding row (no gather on the
    [B, S, V] logits), as the reference computes it.

    With the vocabulary split over ``model`` each rank holds its columns of
    the logits: the max and the sum of exponentials are reduced over
    ``model`` (the max held constant), and the label's logit comes from the
    rank that holds its row."""
    W = unembed_matrix(params)                         # [d, V] or [d, V/tp]
    labels = labels.long()
    if not _vocab_split(params):
        lse = torch.logsumexp(_logits(params, h), dim=-1)  # [B, S]
        rows = W.T[labels]                             # [B, S, d]
        label_logit = (h.float() * rows.float()).sum(-1)
        return (lse - label_logit).mean()
    h = copy_to(h, mesh)
    logits = torch.matmul(h.float(), W.float())        # [B, S, V/tp]
    m = reduce_(logits.detach().amax(-1), mesh, op=dist.ReduceOp.MAX)
    lse = m + torch.log(reduce_from(
        torch.exp(logits - m[..., None]).sum(-1), mesh))
    Vl = W.shape[1]
    lo = axis_index(mesh) * Vl
    mine = (labels >= lo) & (labels < lo + Vl)
    rows = W.T[(labels - lo).clamp(0, Vl - 1)]
    label_logit = reduce_from(
        (h.float() * rows.float()).sum(-1) * mine.float(), mesh)
    return (lse - label_logit).mean()


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict, mesh=None):
    """batch: {"tokens": [B,S]} or {"embeds": [B,S,d]}, with {"labels": [B,S]}.
    Returns (ce + 0.01 * aux, {"ce", "aux"})."""
    h, aux = forward(params, cfg, tokens=batch.get("tokens"),
                     embeds=batch.get("embeds"), mesh=mesh, train=True)
    ce = lm_loss_from_h(params, cfg, h, batch["labels"], mesh)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# =============================================================================
# serving: prefill + decode
# =============================================================================

def _stacked(one: Dict, *lead: int) -> Dict:
    return {key: val.expand(*lead, *val.shape).clone() for key, val in one.items()}


def make_caches(cfg: ModelConfig, batch: int, length: int,
                dtype=torch.bfloat16, device="cuda") -> Dict:
    L = cfg.n_layers
    if cfg.family in ("dense", "moe"):
        return {"attn": _stacked(make_cache(cfg, batch, length, dtype, device), L)}
    if cfg.family == "ssm":
        return {"ssm": _stacked(make_ssm_cache(cfg, batch, dtype, device), L)}
    G, P, tail = _groups(cfg)
    ssm_one = make_ssm_cache(cfg, batch, dtype, device)
    return {
        "ssm_main": _stacked(ssm_one, G, P),
        "ssm_tail": _stacked(ssm_one, tail),
        "attn": _stacked(make_cache(cfg, batch, length, dtype, device), G),
    }


def _pad_window(cache: Dict, window: int) -> Dict:
    """Axis -3 (the window) of every KV leaf padded up to ``window``."""
    pad = window - cache["k"].shape[-3]
    return {key: (val if key == "pos" else torch.nn.functional.pad(
        val, (0, 0, 0, 0, 0, pad))) for key, val in cache.items()}


def grow_caches(cfg: ModelConfig, caches: Dict, window: int,
                mesh=None) -> Dict:
    """Pad attention KV windows (from prefill) up to ``window`` for
    decoding: axis 2 of the stacked [L, B, S, ...] tensors.

    Under a ``model`` axis the caches are in ``cache_specs``' layout
    (``layers.kv_window``): a split window is gathered whole, padded at its
    end, and cut again by ``cache_specs`` at the new window (padding each
    rank's slice would put the padding inside the window)."""
    out = dict(caches)
    attn = caches.get("attn")
    if attn is None:
        return out
    if axis_size(mesh) > 1:
        if kv_window(attn, mesh)[0] < window:
            out["attn"] = mesh_cache(
                _pad_window(whole_cache(attn, mesh), window), mesh)
        return out
    if attn["k"].shape[2] < window:
        out["attn"] = _pad_window(attn, window)
    return out


def _decode(params, cfg: ModelConfig, tokens, caches: Dict, mesh, embeds,
            inplace: bool):
    """The body of ``decode_step`` and ``decode_step_``."""
    h = embed_tokens(params, tokens, mesh) if embeds is None else embeds
    B = h.shape[0]
    if "attn" in caches:
        # a copy: an in-place step advances every layer's pos as it goes
        positions = caches["attn"]["pos"][0].expand(B, 1).clone()

    if cfg.family in ("dense", "moe"):
        new = []
        for i, p in enumerate(params.layers):
            h, _, c = _dense_block(p, h, positions, cfg, mesh,
                                   cache=_index(caches["attn"], i),
                                   inplace=inplace)
            new.append(c)
        new_caches = caches if inplace else {"attn": _stack(new)}
    elif cfg.family == "ssm":
        new = []
        for i, p in enumerate(params.layers):
            h, c = _ssm_layer(p, h, cfg, cache=_index(caches["ssm"], i),
                              mesh=mesh, inplace=inplace)
            new.append(c)
        new_caches = caches if inplace else {"ssm": _stack(new)}
    else:  # hybrid
        G, P, tail = _groups(cfg)
        main, attn = [], []
        for g in range(G):
            group_c = _index(caches["ssm_main"], g)
            group = []
            for j in range(P):
                h, c = _ssm_layer(params.layers[g * P + j], h, cfg,
                                  cache=_index(group_c, j), mesh=mesh,
                                  inplace=inplace)
                group.append(c)
            if not inplace:
                main.append(_stack(group))
            h, c = _shared_attn_block(params.shared_attn, h, positions, cfg,
                                      cache=_index(caches["attn"], g),
                                      mesh=mesh, inplace=inplace)
            attn.append(c)
        tails = []
        for j in range(tail):
            h, c = _ssm_layer(params.layers[G * P + j], h, cfg,
                              cache=_index(caches["ssm_tail"], j),
                              mesh=mesh, inplace=inplace)
            tails.append(c)
        if inplace:
            new_caches = caches
        else:
            new_caches = {"ssm_main": _stack(main),
                          "ssm_tail": (_stack(tails) if tail
                                       else caches["ssm_tail"]),
                          "attn": _stack(attn)}

    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, h, mesh)[:, 0], new_caches


def decode_step(params: LM, cfg: ModelConfig, tokens, caches: Dict, mesh=None,
                embeds=None):
    """One token for every sequence in the batch.  tokens: [B, 1].

    Returns (f32 logits [B, V], new caches); ``caches`` is not modified.
    Decode positions come from ``caches["attn"]["pos"][0]``."""
    return _decode(params, cfg, tokens, caches, mesh, embeds, inplace=False)


def decode_step_(params: LM, cfg: ModelConfig, tokens, caches: Dict,
                 mesh=None, embeds=None) -> torch.Tensor:
    """``decode_step`` writing ``caches`` in place: each attention layer
    writes its slot (``index_copy_``) and advances its ``pos``, each SSM
    layer writes its ``conv`` and ``state`` (``copy_``); no window is
    copied.  Returns the f32 logits [B, V], the same bits as
    ``decode_step``'s."""
    return _decode(params, cfg, tokens, caches, mesh, embeds,
                   inplace=True)[0]


def prefill(params: LM, cfg: ModelConfig, tokens=None, embeds=None, mesh=None):
    """Process the prompt; returns (last-position f32 logits, caches primed
    at S).  For attention families the cache window equals the prompt
    length (``grow_caches`` pads it for decoding).  Under a ``model`` axis
    the caches come back in ``launch.partition.cache_specs``' layout, as
    the reference's ``out_shardings`` give them, ready for ``decode_step``
    on the same mesh."""
    h = embed_tokens(params, tokens, mesh) if embeds is None else embeds
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)

    def ssm_cache():
        return make_ssm_cache(cfg, B, h.dtype, h.device)

    if cfg.family in ("dense", "moe"):
        new = []
        for p in params.layers:
            h, _, c = _dense_block(p, h, positions, cfg, mesh, cache={})
            new.append(c)
        new_caches = {"attn": _stack(new)}
    elif cfg.family == "ssm":
        new = []
        for p in params.layers:
            h, c = _ssm_layer(p, h, cfg, cache=ssm_cache(), mesh=mesh)
            new.append(c)
        new_caches = {"ssm": _stack(new)}
    else:
        G, P, tail = _groups(cfg)
        main, attn = [], []
        for g in range(G):
            group = []
            for j in range(P):
                h, c = _ssm_layer(params.layers[g * P + j], h, cfg,
                                  cache=ssm_cache(), mesh=mesh)
                group.append(c)
            main.append(_stack(group))
            h, c = _shared_attn_block(params.shared_attn, h, positions, cfg,
                                      cache={}, mesh=mesh)
            attn.append(c)
        tails = []
        for j in range(tail):
            h, c = _ssm_layer(params.layers[G * P + j], h, cfg,
                              cache=ssm_cache(), mesh=mesh)
            tails.append(c)
        new_caches = {"ssm_main": _stack(main),
                      "ssm_tail": _stack(tails) if tails else None,
                      "attn": _stack(attn)}

    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, h[:, -1], mesh), new_caches
