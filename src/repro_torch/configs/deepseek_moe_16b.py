"""deepseek-moe-16b [arXiv:2401.06066; hf]

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed experts, top-6 (fine-grained experts).
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    activation="swiglu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_impl="a2a",
    microbatch=2,
))
