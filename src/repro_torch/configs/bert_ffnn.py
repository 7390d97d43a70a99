"""The paper's own experimental target: a BERT-large encoder FFNN.

Depth-2 MLP with weight matrices 1024x4096 and 4096x1024 (paper VI.A.5/VI.B.2),
magnitude-pruned at varying densities.  Used by benchmarks (fig6/fig8) and the
serving example; not part of the assigned 10-arch dry-run grid.
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="bert-ffnn",
    family="dense",
    n_layers=2,
    d_model=1024,
    d_ff=4096,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    vocab=30522,
    activation="gelu",
))
