"""stablelm-12b [hf:stabilityai/stablelm-2-12b family; hf]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    activation="swiglu",
    microbatch=8,
))
