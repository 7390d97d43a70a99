"""Model zoo: dense/MoE/SSM/hybrid decoder LMs + encoder-decoder (port of
``repro.models``: serving and training on one device)."""

from . import encdec, lm
from .config import (
    LM_SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    list_configs,
)

__all__ = [
    "encdec", "lm", "LM_SHAPES", "ModelConfig", "ShapeConfig",
    "applicable_shapes", "get_config", "list_configs",
]
