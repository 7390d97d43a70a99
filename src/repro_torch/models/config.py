"""Model & shape configuration dataclasses + the architecture registry."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    modality: str = "text"       # text | vision_stub | audio_stub
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: Optional[int] = None
    activation: str = "swiglu"   # swiglu | squared_relu | gelu
    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dense"      # dense (sort/scatter, pjit) | a2a (shard_map)
    # --- SSM (mamba2 / SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- hybrid (zamba2): shared attention block every `attn_period` layers --
    attn_period: int = 0
    # --- enc-dec ------------------------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    tgt_frac: int = 4            # train target length = seq_len // tgt_frac
    # --- numerics / training --------------------------------------------------
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    remat: bool = True
    microbatch: int = 1          # gradient-accumulation steps inside train_step
    attn_chunk: int = 512        # flash-attention query-chunk length
    # beyond-paper perf knobs (see EXPERIMENTS.md §Perf)
    fuse_qkv: bool = True
    bf16_reduce: bool = False   # TP partial sums cross chips in bf16 (not f32)
    kv_quant: bool = False      # int8 KV cache with per-(token,head) scales

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per = (d * (2 * di + 2 * ns + self.ssm_heads)  # in_proj(z,x)+B,C,dt
                   + self.ssm_conv * (di + 2 * ns)          # depthwise conv
                   + di * d + 2 * self.ssm_heads + di)       # out_proj, A, D, norm
            return self.n_layers * per + v * d + (0 if self.tie_embeddings else v * d)
        att = d * (self.n_heads * self.hd) + d * (2 * self.n_kv_heads * self.hd) \
            + (self.n_heads * self.hd) * d
        if self.activation == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            mlp = (self.n_experts + self.n_shared_experts) * mlp + d * self.n_experts
        if self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            per = (d * (2 * di + 2 * ns + self.ssm_heads)
                   + self.ssm_conv * (di + 2 * ns) + di * d + 2 * self.ssm_heads + di)
            shared = att + mlp  # one shared attention block
            return self.n_layers * per + shared + v * d * 2
        layers = self.n_layers if self.family != "encdec" \
            else (self.n_enc_layers + self.n_dec_layers)
        per = att + mlp
        if self.family == "encdec":
            per = per + att  # cross-attention in decoder (approx: count once avg)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return layers * per + emb

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        per_expert = 3 * d * f if self.activation == "swiglu" else 2 * d * f
        total = self.n_params()
        inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic-attention rule: long_500k runs only for SSM/hybrid archs.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        names.append("long_500k")
    return tuple(names)


# --------------------------------------------------------------------------
# registry (populated by repro.configs)
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  — populates the registry

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    import repro_torch.configs  # noqa: F401

    return dict(_REGISTRY)
