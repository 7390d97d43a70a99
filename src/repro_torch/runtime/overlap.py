"""Compute/communication overlap: ring collective matmul.

Port of ``repro.runtime.overlap``.  ``ring_ag_matmul`` computes y =
all_gather(x) @ W with W column-sharded, as a ring: each of the tp steps
multiplies the x shard it holds against the local W panel while the next
shard is in flight (``dist.batch_isend_irecv`` to the ring neighbours,
started before the product and waited on after it).  This replaces the
blocking all-gather + big matmul with tp pipelined chunks.

Semantics are exactly all_gather+matmul; tests assert equality.  On a
``gloo`` group with CUDA tensors the exchange takes a host round trip
(``models.sharding``), so the overlap there is with the host copy.
"""

from __future__ import annotations

import torch

from ..models.sharding import axis_index, axis_size, ring_start


def ring_ag_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                   tp_axis: str = "model") -> torch.Tensor:
    """This rank's ``y[B, S, F/tp]`` of ``x[B, S, D] @ w[D, F]``, from its
    sequence shard ``x [B, S/tp, D]`` and column shard ``w [D, F/tp]`` on a
    bound mesh (the reference's shard_map body)."""
    tp = axis_size(mesh, tp_axis)
    idx = axis_index(mesh, tp_axis)
    B, s_loc, _ = x.shape
    y = x.new_empty((B, s_loc * tp, w.shape[1]))
    buf = x
    for i in range(tp):
        # buf holds the shard that originated at rank (idx - i) mod tp
        nxt = ring_start(buf, mesh, tp_axis) if i < tp - 1 else None
        src = (idx - i) % tp
        y[:, src * s_loc:(src + 1) * s_loc] = torch.matmul(buf, w)
        if nxt is not None:
            buf = nxt.wait()
    return y
