"""Input stand-ins per (architecture x shape) on the ``meta`` device: shapes
and dtypes, no allocation.

Port of ``repro.launch.specs``: where the reference returns
``jax.ShapeDtypeStruct``s, these are ``device="meta"`` tensors, and
``params_shape`` is the model built on ``meta``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import encdec, lm
from ..models.config import LM_SHAPES, ModelConfig, ShapeConfig


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        St = S // cfg.tgt_frac
        return {
            "src_embeds": sds((B, S, cfg.d_model), torch.bfloat16),
            "tgt_tokens": sds((B, St), torch.int32),
            "labels": sds((B, St), torch.int32),
        }
    if cfg.modality == "vision_stub":
        return {
            "embeds": sds((B, S, cfg.d_model), torch.bfloat16),
            "labels": sds((B, S), torch.int32),
        }
    return {
        "tokens": sds((B, S), torch.int32),
        "labels": sds((B, S), torch.int32),
    }


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"src_embeds": sds((B, S, cfg.d_model), torch.bfloat16),
                "tgt_tokens": sds((B, S // cfg.tgt_frac), torch.int32)}
    if cfg.modality == "vision_stub":
        return {"embeds": sds((B, S, cfg.d_model), torch.bfloat16)}
    return {"tokens": sds((B, S), torch.int32)}


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, Dict]:
    """Returns (caches_shape_tree, token_inputs) for one serve step with a
    KV window of ``shape.seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        enc_out = sds((B, S, cfg.d_model), torch.bfloat16)
        caches = encdec.make_dec_caches(params_shape(cfg), cfg, enc_out,
                                        window=S)
        return caches, {"tokens": sds((B, 1), torch.int32)}
    caches = lm.make_caches(cfg, B, S, device="meta")
    return caches, {"tokens": sds((B, 1), torch.int32)}


def params_shape(cfg: ModelConfig, dtype=torch.bfloat16):
    """The model on the ``meta`` device, in the reference's init dtype."""
    cls = encdec.EncDec if cfg.family == "encdec" else lm.LM
    return cls(cfg, device="meta", dtype=dtype)


def shape_by_name(name: str) -> ShapeConfig:
    return LM_SHAPES[name]
