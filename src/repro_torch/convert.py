"""Carry block-sparse weights from the JAX package into the port.

``layers_from_numpy`` takes any objects with the ``BSRLayer`` fields
(``n_in``, ``n_out``, ``block_m``, ``block_n``, ``rows``, ``cols``,
``blocks``, ``bias``) — the JAX package's layers by duck typing, without
importing that package — and returns the port's own ``BSRLayer``s, so both
packages compile the same net.

The engine's plan cache keys on the identity of each layer object: convert
once and keep the returned list, rather than converting again per compile.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .core.blocksparse import BSRLayer


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
