"""seamless-m4t-medium [arXiv:2308.11596; hf] — encoder-decoder, multimodal.

12L (encoder) + 12L (decoder) d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206.  Speech frontend is a STUB: input_specs provides precomputed
frame embeddings for the encoder; target length = seq_len // tgt_frac.
"""

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    modality="audio_stub",
    n_layers=24,
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    activation="gelu",
    tgt_frac=4,
))
