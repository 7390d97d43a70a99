"""Prefill / serve step builders (port of ``repro.launch.steps``; the
train step waits for the training slice)."""

from __future__ import annotations

import torch

from ..models import encdec, lm
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, mesh=None):
    def prefill_step(params, batch):
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, cfg, batch["src_embeds"])
            h = encdec.decode_train(params, cfg, enc_out, batch["tgt_tokens"])
            logits = torch.matmul(h[:, -1].float(),
                                  encdec.unembed_matrix(params).float())
            return logits, enc_out
        return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One decode step: greedy next token [B, 1] (int32) + updated caches."""

    def serve_step(params, caches, tokens):
        if cfg.family == "encdec":
            logits, new_caches = encdec.decode_step(params, cfg, tokens, caches)
        else:
            logits, new_caches = lm.decode_step(params, cfg, tokens, caches,
                                                mesh=mesh)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, new_caches

    return serve_step
