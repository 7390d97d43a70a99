"""Elastic scaling: restore any checkpoint onto a different mesh.

Port of ``repro.runtime.elastic``.  Checkpoints are stored as host-complete
arrays (``checkpoint.store``), so scaling from N to M ranks is a re-shard
at load: build the param/opt specs for the NEW mesh and let each rank read
its own slices.  This is the recovery path when a host is lost (shrink) or
capacity returns (grow): training resumes from the last good step with the
same numerics modulo data order.
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Tuple

import torch

from ..checkpoint import CheckpointManager
from ..launch import partition
from ..models.sharding import axes_from_mesh


def shardings_for(mesh, cfg, params_shape, opt_shape=None):
    """``NamedSharding`` trees of the parameters and (given its shapes) the
    optimizer state on ``mesh``: ``(p_shard, o_shard or None)``."""
    p_specs = partition.params_specs(mesh, params_shape)
    p_shard = partition.to_named(mesh, p_specs)
    if opt_shape is None:
        return p_shard, None
    o_specs = partition.opt_specs(mesh, opt_shape, p_specs)
    return p_shard, partition.to_named(mesh, o_specs)


def _specs(shard):
    return {k: (_specs(v) if isinstance(v, dict) else v.spec)
            for k, v in shard.items()}


def reshard_checkpoint(
    ckpt: CheckpointManager,
    cfg,
    new_mesh,
    params_shape,
    opt_shape,
    step: Optional[int] = None,
    device=None,
) -> Tuple[Any, Any]:
    """Load (params, opt_state) from ``ckpt`` resharded onto ``new_mesh``
    (bound, or a single slot): this rank's slices, on ``device``.

    ``params_shape`` is the model on ``meta`` (``launch.specs.
    params_shape``), ``opt_shape`` its ``adamw_init`` state; neither is
    changed.  Returns the model holding this rank's parameter slices and
    the optimizer state holding its ZeRO slices."""
    axes_from_mesh(new_mesh)
    p_shard, o_shard = shardings_for(new_mesh, cfg, params_shape, opt_shape)
    o_specs = _specs(o_shard)
    params = partition.shard_module(copy.deepcopy(params_shape),
                                    _specs(p_shard), new_mesh, device=device)
    opt = {"step": torch.zeros((), dtype=opt_shape["step"].dtype,
                               device=device)}
    for key in ("master", "mu", "nu"):
        depth = partition.depths(o_specs[key])
        opt[key] = {
            name: torch.empty(partition.local_shape(
                leaf.shape, partition.leaf_spec(name, o_specs[key][name]),
                new_mesh), dtype=leaf.dtype, device=device)
            for name, leaf in opt_shape[key].items()
            if partition.owns(name, o_specs[key][name], new_mesh, depth)}
    tree = ckpt.restore(
        {"params": params, "opt": opt},
        step=step,
        target_shardings={"params": p_shard, "opt": o_shard},
    )
    return tree["params"], tree["opt"]
