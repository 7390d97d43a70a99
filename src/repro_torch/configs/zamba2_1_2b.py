"""zamba2-1.2b [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One shared attention+MLP block applied every `attn_period` Mamba2 layers
(38 = 6 groups of 6 + 2 tail layers).  Runs long_500k (hybrid family).
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    activation="swiglu",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_period=6,
    microbatch=4,
))
