"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B; hf]

32L d_model=4096 32H (GQA kv=32 — MHA) d_ff=13440 vocab=92416, qwen1.5 arch.
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    activation="swiglu",
    microbatch=4,
))
