"""Carry weights from the JAX package into the port.

``layers_from_numpy`` takes any objects with the ``BSRLayer`` fields
(``n_in``, ``n_out``, ``block_m``, ``block_n``, ``rows``, ``cols``,
``blocks``, ``bias``) — the JAX package's layers by duck typing, without
importing that package — and returns the port's own ``BSRLayer``s, so both
packages compile the same net.

The engine's plan cache keys on the identity of each layer object: convert
once and keep the returned list, rather than converting again per compile.

``lm_params_from_numpy`` takes a language model's parameter tree (``lm`` or
``encdec``) as nested dicts of numpy arrays and returns the port's module
holding those weights.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from .core.blocksparse import BSRLayer
from .models import encdec, lm
from .models.config import ModelConfig

# tree keys whose leaves stack the layers on a leading [L, ...] axis
_STACKED = ("layers", "enc_layers", "dec_layers")


def layers_from_numpy(layers: Sequence[object]) -> List[BSRLayer]:
    """Copy each layer's fields into a port ``BSRLayer`` (numpy arrays with
    the reference dtypes: int32 tile indices, float32 blocks and bias)."""
    return [
        BSRLayer(
            n_in=int(lay.n_in),
            n_out=int(lay.n_out),
            block_m=int(lay.block_m),
            block_n=int(lay.block_n),
            rows=np.asarray(lay.rows, dtype=np.int32),
            cols=np.asarray(lay.cols, dtype=np.int32),
            blocks=np.asarray(lay.blocks, dtype=np.float32),
            bias=np.asarray(lay.bias, dtype=np.float32),
        )
        for lay in layers
    ]


def _state_items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(state_dict name, array) of every leaf; a stacked leaf gives one
    entry per layer, ``layers.{i}.<path>``."""
    for key, val in tree.items():
        if isinstance(val, dict):
            if not prefix and key in _STACKED:
                for path, arr in _state_items(val):
                    for i in range(arr.shape[0]):
                        yield f"{key}.{i}.{path}", arr[i]
            else:
                yield from _state_items(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def lm_params_from_numpy(cfg: ModelConfig, tree: Dict,
                         device: Union[str, torch.device] = "cuda"):
    """The port's ``lm.LM`` (or ``encdec.EncDec`` for the encdec family)
    holding the reference's weights.

    ``tree`` is the reference's parameter tree with numpy leaves (for
    example ``jax.tree.map(np.asarray, params)``): layers stacked on a
    leading axis, ``shared_attn`` for the hybrid.  Leaves keep their dtype
    (numpy has no bfloat16: cast such a tree to float32 first).  Every leaf
    must have its module parameter of the same shape, and every parameter
    its leaf."""
    state = {name: torch.tensor(arr) for name, arr in _state_items(tree)}
    cls = encdec.EncDec if cfg.family == "encdec" else lm.LM
    model = cls(cfg, device=device, dtype=state["embed"].dtype)
    model.load_state_dict(state, strict=True)
    return model
