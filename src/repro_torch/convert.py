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
holding those weights; ``lm_params_to_numpy`` is its inverse.
``opt_state_to_numpy`` / ``opt_state_from_numpy`` do the same for an
optimizer state.  ``reference_layout`` is the shared rule: ``state_dict``
names become the reference's nested tree, per-layer tensors stacked on a
leading ``[L, ...]`` axis.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple, Union

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


class Stacked(list):
    """Per-layer tensors that the reference keeps as one leaf, stacked on a
    leading ``[L, ...]`` axis (layer ``i`` at index ``i``)."""


def reference_layout(named: Mapping[str, Any]) -> Dict:
    """``state_dict`` names -> the reference's nested tree.

    ``layers.3.attn.wq`` lands at ``tree["layers"]["attn"]["wq"][3]``, a
    ``Stacked`` leaf (likewise ``enc_layers`` and ``dec_layers``); every
    other dotted name nests (``shared_attn.attn.wq``).  Names must come in
    layer order, as ``named_parameters`` gives them."""
    tree: Dict = {}
    for name, val in named.items():
        parts = name.split(".")
        node = tree
        if parts[0] in _STACKED:
            key, idx, rest = parts[0], int(parts[1]), parts[2:]
            node = node.setdefault(key, {})
            for part in rest[:-1]:
                node = node.setdefault(part, {})
            stack = node.setdefault(rest[-1], Stacked())
            if len(stack) != idx:
                raise ValueError(f"{name}: layer {idx} after {len(stack)} "
                                 f"layers of {'.'.join([key] + rest)}")
            stack.append(val)
        else:
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = val
    return tree


def _numpy(leaf) -> np.ndarray:
    """A host f32/int copy of a leaf (bf16 widens to f32 exactly)."""
    if isinstance(leaf, Stacked):
        return np.stack([_numpy(x) for x in leaf])
    t = leaf.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy().copy()


def _numpy_tree(tree: Dict) -> Dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else _numpy(v)
            for k, v in tree.items()}


def named_to_numpy(named: Mapping[str, torch.Tensor]) -> Dict:
    """Tensors keyed by ``state_dict`` names (parameters, gradients, one of
    an optimizer state's trees) as the reference's tree of numpy arrays.
    numpy has no bfloat16, so bf16 leaves come back as float32
    (exactly)."""
    return _numpy_tree(reference_layout(named))


def lm_params_to_numpy(model) -> Dict:
    """The inverse of ``lm_params_from_numpy``: the module's parameters as
    the reference's tree of numpy arrays (layers stacked, ``shared_attn``,
    ``enc_layers`` / ``dec_layers``; bf16 as float32)."""
    return named_to_numpy(dict(model.named_parameters()))


def opt_state_to_numpy(state: Mapping[str, Any]) -> Dict:
    """An ``adamw_init`` state as the reference's: ``master``, ``mu`` and
    ``nu`` trees in its layout, ``step`` an int32 scalar array."""
    out = {key: named_to_numpy(state[key]) for key in ("master", "mu", "nu")}
    out["step"] = np.asarray(int(state["step"]), dtype=np.int32)
    return out


def opt_state_from_numpy(tree: Mapping[str, Any],
                         device: Union[str, torch.device] = "cuda") -> Dict:
    """The reference's optimizer state (numpy leaves) as the port's:
    ``master``, ``mu`` and ``nu`` keyed by ``state_dict`` names, ``step``
    an int32 scalar tensor, all on ``device``."""
    out = {key: {name: torch.tensor(arr, device=device)
                 for name, arr in _state_items(tree[key])}
           for key in ("master", "mu", "nu")}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out
