"""internvl2-26b [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Per the assignment the ViT frontend is a STUB: input_specs provides
precomputed patch embeddings [B, S, d] for train/prefill; decode uses the
text embedding table.
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="dense",
    modality="vision_stub",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    activation="swiglu",
    microbatch=16,
))
