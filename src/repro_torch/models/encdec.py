"""Encoder-decoder transformer (seamless-m4t backbone).

Port of ``repro.models.encdec``.  The speech/text frontend is a stub: the
encoder consumes precomputed frame embeddings [B, S_src, d].  The decoder
is a causal transformer with cross-attention; ``decode_step`` runs one
target token against a self-attention KV cache plus the precomputed
cross-attention cache.  In training with ``cfg.remat`` each encoder and
decoder layer is recomputed in the backward pass, as the reference's
``jax.checkpoint`` does.  Under a ``model`` axis the attention and MLP
layers and the vocabulary run split as in ``lm``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .common import dense_init_, param, rms_norm
from .config import ModelConfig
from .layers import MLP, Attention, attention, make_cache, mlp
from .lm import (AttnBlock, _index, _logits, _maybe_remat, _positions, _stack,
                 _stacked, embed_tokens, lm_loss_from_h, unembed_matrix)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = param((d,), device, dtype)
        self.self_attn = Attention(cfg, device, dtype)
        self.ln_x = param((d,), device, dtype)
        self.cross_attn = Attention(cfg, device, dtype)
        self.ln2 = param((d,), device, dtype)
        self.mlp = MLP(cfg, device, dtype)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for ln in (self.ln1, self.ln_x, self.ln2):
            ln.fill_(1.0)
        self.self_attn.init_(gen)
        self.cross_attn.init_(gen)
        self.mlp.init_(gen)


class EncDec(nn.Module):
    """The reference's tree as modules (``enc_layers.i.*``,
    ``dec_layers.i.*`` for its stacked ``[L, ...]`` leaves)."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=torch.bfloat16):
        super().__init__()
        d, V = cfg.d_model, cfg.vocab
        self.vocab = V
        self.embed = param((V, d), device, dtype)
        self.enc_layers = nn.ModuleList(
            [AttnBlock(cfg, device, dtype) for _ in range(cfg.n_enc_layers)])
        self.dec_layers = nn.ModuleList(
            [DecBlock(cfg, device, dtype) for _ in range(cfg.n_dec_layers)])
        self.enc_norm = param((d,), device, dtype)
        self.final_norm = param((d,), device, dtype)
        self.unembed = param((d, V), device, dtype)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        dense_init_(self.embed, gen, in_axis=1)
        for block in (*self.enc_layers, *self.dec_layers):
            block.init_(gen)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)
        dense_init_(self.unembed, gen)


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=torch.bfloat16) -> EncDec:
    """Random weights with the reference's distributions, drawn from
    ``generator`` on its device (see ``lm.init``)."""
    model = EncDec(cfg, device=generator.device, dtype=dtype)
    model.init_(generator)
    return model


def encode(params: EncDec, cfg: ModelConfig, src_embeds: torch.Tensor,
           train: bool = False, mesh=None):
    B, S = src_embeds.shape[:2]
    positions = _positions(B, S, src_embeds.device)

    def body(p, hh):
        a, _ = attention(p.attn, rms_norm(hh, p.ln1, cfg.norm_eps),
                         positions, cfg, causal=False, mesh=mesh)
        hh = hh + a
        return hh + mlp(p.mlp, rms_norm(hh, p.ln2, cfg.norm_eps), cfg, mesh)

    body = _maybe_remat(body, cfg, train)
    h = src_embeds
    for p in params.enc_layers:
        h = body(p, h)
    return rms_norm(h, params.enc_norm, cfg.norm_eps)


def _dec_block(p: DecBlock, h, positions, enc_out, cfg: ModelConfig,
               self_cache=None, cross_cache=None, mesh=None):
    a, new_self = attention(p.self_attn, rms_norm(h, p.ln1, cfg.norm_eps),
                            positions, cfg, causal=True, cache=self_cache,
                            mesh=mesh)
    h = h + a
    x, new_cross = attention(p.cross_attn, rms_norm(h, p.ln_x, cfg.norm_eps),
                             positions, cfg, causal=False, cache=cross_cache,
                             kv_from=enc_out, cross=True, mesh=mesh)
    h = h + x
    h = h + mlp(p.mlp, rms_norm(h, p.ln2, cfg.norm_eps), cfg, mesh)
    return h, new_self, new_cross


def decode_train(params: EncDec, cfg: ModelConfig, enc_out, tgt_tokens,
                 train: bool = False, mesh=None):
    """Teacher-forced decoder over the whole target: final-normed h."""
    B, S = tgt_tokens.shape
    positions = _positions(B, S, enc_out.device)
    body = _maybe_remat(
        lambda p, hh: _dec_block(p, hh, positions, enc_out, cfg,
                                 mesh=mesh)[0], cfg, train)
    h = embed_tokens(params, tgt_tokens, mesh)
    for p in params.dec_layers:
        h = body(p, h)
    return rms_norm(h, params.final_norm, cfg.norm_eps)


def loss_fn(params: EncDec, cfg: ModelConfig, batch: Dict, mesh=None):
    """batch: {"src_embeds": [B,Ss,d], "tgt_tokens": [B,St], "labels": [B,St]}.
    Returns (ce, {"ce", "aux" = 0})."""
    enc_out = encode(params, cfg, batch["src_embeds"], train=True, mesh=mesh)
    h = decode_train(params, cfg, enc_out, batch["tgt_tokens"], train=True,
                     mesh=mesh)
    ce = lm_loss_from_h(params, cfg, h, batch["labels"], mesh)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def make_dec_caches(params: EncDec, cfg: ModelConfig, enc_out, window: int,
                    dtype=torch.bfloat16) -> Dict:
    """Self caches (empty, ``window`` long) + cross caches (from enc_out)."""
    B, Skv = enc_out.shape[:2]
    K, hd = cfg.n_kv_heads, cfg.hd
    one = make_cache(cfg, B, window, dtype, enc_out.device)
    cross = [{"k": torch.matmul(enc_out, p.cross_attn.wk).reshape(B, Skv, K, hd)
              .to(dtype),
              "v": torch.matmul(enc_out, p.cross_attn.wv).reshape(B, Skv, K, hd)
              .to(dtype)}
             for p in params.dec_layers]
    return {"self": _stacked(one, cfg.n_dec_layers), "cross": _stack(cross)}


def decode_step(params: EncDec, cfg: ModelConfig, tokens, caches: Dict,
                mesh=None):
    """tokens: [B, 1] target token; caches from ``make_dec_caches``.
    Returns (f32 logits [B, V], new caches); ``caches`` is not modified."""
    h = embed_tokens(params, tokens, mesh)
    positions = caches["self"]["pos"][0].expand(h.shape[0], 1)
    new_self = []
    for i, p in enumerate(params.dec_layers):
        h, c, _ = _dec_block(p, h, positions, None, cfg,
                             self_cache=_index(caches["self"], i),
                             cross_cache=_index(caches["cross"], i), mesh=mesh)
        new_self.append(c)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, h, mesh)[:, 0], {"self": _stack(new_self),
                                      "cross": caches["cross"]}


__all__ = ["DecBlock", "EncDec", "decode_step", "decode_train", "encode",
           "init", "loss_fn", "make_dec_caches", "unembed_matrix"]
