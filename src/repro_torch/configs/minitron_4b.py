"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
The *pruned* provenance makes this the closest assigned arch to the paper's
own regime (sparsified dense layers).
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    activation="squared_relu",
    microbatch=4,
))
