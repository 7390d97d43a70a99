"""Architecture registry: one module per assigned architecture.

Importing this package registers all configs; ``reduced(cfg)`` derives the
small same-family variant used by the CPU smoke tests (the full configs are
exercised only via the dry-run, shape-only)."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, get_config, list_configs, register

from . import (  # noqa: F401  (registration side effects)
    granite_moe_1b_a400m,
    deepseek_moe_16b,
    nemotron_4_15b,
    stablelm_12b,
    minitron_4b,
    codeqwen1_5_7b,
    internvl2_26b,
    seamless_m4t_medium,
    mamba2_1_3b,
    zamba2_1_2b,
    bert_ffnn,
)

ARCH_IDS = [
    "granite-moe-1b-a400m",
    "deepseek-moe-16b",
    "nemotron-4-15b",
    "stablelm-12b",
    "minitron-4b",
    "codeqwen1.5-7b",
    "internvl2-26b",
    "seamless-m4t-medium",
    "mamba2-1.3b",
    "zamba2-1.2b",
]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for one-forward/one-train-step CPU smoke tests."""
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, 2))
    if heads % kv:
        kv = 1
    changes = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=max(64, min(cfg.d_ff, 128)),
        vocab=256,
        microbatch=1,
        attn_chunk=16,
        remat=False,
    )
    if cfg.family == "moe":
        changes.update(n_experts=4, top_k=2,
                       n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        changes.update(n_layers=3, attn_period=2)
    if cfg.family == "encdec":
        changes.update(n_enc_layers=2, n_dec_layers=2)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "list_configs", "reduced",
           "register"]
