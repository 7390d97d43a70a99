"""mamba2-1.3b [arXiv:2405.21060; unverified] — SSD (state-space duality).

48L d_model=2048 (attention-free), ssm_state=128, head_dim=64, expand=2.
Runs the long_500k shape (sub-quadratic by construction).
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    d_ff=0,
    n_heads=0,
    n_kv_heads=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
    microbatch=4,
))
