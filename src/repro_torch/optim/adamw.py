"""AdamW with fp32 master weights, global-norm clipping, cosine schedule.

Port of ``repro.optim.adamw``.  The state is the
reference's ``{"master", "mu", "nu", "step"}``; ``master``, ``mu`` and
``nu`` map each parameter's ``state_dict`` name to an f32 tensor (the
checkpoint store and ``repro_torch.convert`` stack them into the
reference's tree), and ``step`` is an int32 scalar tensor on the
parameters' device, so the schedule is computed there without a host sync.

``adamw_update`` keeps the reference's formula and order: clip every
gradient by the global norm, then the moments, then the bias-corrected
``mhat / (sqrt(nhat) + eps)`` plus decoupled weight decay, then the cast
to each parameter's dtype.  It updates groups of leaves (at most
``_GROUP`` elements each) through ``kernels.adamw.adamw_fused``: on the
card one launch of the fused kernel per group (the counterpart of XLA's
fusion of this update under ``jit``), on the CPU its plain version, the
``torch._foreach_*`` sequence, bit for bit the same; ``master``, ``mu`` and
``nu`` are updated in place, and so is the step counter.

On a mesh (``mesh`` and the optimizer state's specs, ``launch.partition.
opt_specs``) the state holds this rank's ZeRO slices: each data rank
updates only its slice, then the new parameters are all-gathered over the
data axes in their own dtype (ZeRO-1).  ``global_norm`` then counts every
element once: a leaf split over an axis sums its squares over it, a leaf
replicated over it is counted on the axis' first rank only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..kernels.adamw import adamw_fused
from ..launch.mesh import dp_axes
from ..launch.partition import gather_named
from ..models.sharding import reduce_

# elements per group of leaves that one fused launch (or one round of the
# plain version's foreach calls, whose temporaries it bounds) updates
_GROUP = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named_params(params: Union[nn.Module, Mapping[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """``{state_dict name: tensor}`` of a module (its parameters) or a
    mapping (as given)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> Dict[str, Any]:
    """f32 copies of the parameters as ``master``, zero moments, step 0."""
    named = named_params(params)
    device = next(iter(named.values())).device
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in named.items()},
        "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()},
        "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; f32 on step's
    device."""
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _split_axes(spec) -> set:
    return {a for e in spec if e for a in ((e,) if isinstance(e, str) else e)}


def global_norm(tensors: Union[Sequence[torch.Tensor],
                               Mapping[str, torch.Tensor]],
                mesh=None, specs: Optional[Mapping] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, as the
    reference sums them (leaf by leaf).  Not ``torch._foreach_norm`` or
    ``linalg.vector_norm``: on the CPU they sum a large f32 tensor in one
    running f32 total (4M elements: 8e-5 off), where ``sum`` sums
    pairwise.

    With ``mesh`` and ``specs`` (name -> spec of this rank's slices, a
    mapping given as ``tensors``): each element of the whole tree once,
    summed over the mesh."""
    if mesh is None or mesh.size == 1:
        if isinstance(tensors, Mapping):
            tensors = list(tensors.values())
        return torch.sqrt(torch.stack(
            [torch.sum(torch.square(t.float())) for t in tensors]).sum())
    axes = [a for a in mesh.axis_names if mesh.axis_size(a) > 1]
    parts = []
    for name, t in tensors.items():
        split = _split_axes(specs[name])
        if all(a in split or mesh.coord(a) == 0 for a in axes):
            parts.append(torch.sum(torch.square(t.float())))
    device = next(iter(tensors.values())).device
    total = torch.stack(parts).sum() if parts else torch.zeros((),
                                                               device=device)
    for a in axes:
        total = reduce_(total, mesh, a)
    return torch.sqrt(total)


def _groups(sizes: Sequence[int]) -> List[List[int]]:
    out, cur, n = [], [], 0
    for i, size in enumerate(sizes):
        if cur and n + size > _GROUP:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += size
    return out + ([cur] if cur else [])


def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict[str, Any],
                 params: Mapping[str, torch.Tensor], cfg: OptConfig,
                 mesh=None, specs: Optional[Mapping] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                            Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads`` and ``params`` map names (those of the
    state) to tensors; only the parameters' dtypes are read.

    Returns ``(new_params, new_state, {"grad_norm", "lr"})``: the new
    parameters as fresh tensors of each parameter's dtype, and the state
    whose ``master``, ``mu``, ``nu`` and ``step`` are the given tensors,
    updated in place (``step`` one higher), so that a CUDA graph of the
    update reads and writes the same state at every replay.  With ``mesh`` and ``specs`` (the master's
    specs), ``grads`` and the state hold this rank's ZeRO slices, and the
    new parameters come back whole over the data axes, for every name of
    ``params``."""
    step = opt_state["step"]
    lr = schedule(step, cfg)
    names = list(grads)
    gnorm = global_norm({n: grads[n] for n in names}, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    new_params = {}
    for group in _groups([grads[n].numel() for n in names]):
        gn = [names[i] for i in group]
        new = adamw_fused(
            [grads[n] for n in gn], [opt_state["master"][n] for n in gn],
            [opt_state["mu"][n] for n in gn], [opt_state["nu"][n] for n in gn],
            [params[n].dtype for n in gn], scale, lr, bc1, bc2, cfg.b1,
            cfg.b2, cfg.eps, cfg.weight_decay)
        new_params.update(zip(gn, new))
    if mesh is not None and mesh.size > 1:
        new_params = gather_named(new_params, specs, mesh, dp_axes(mesh))
    step.add_(1)
    new_state = {"master": opt_state["master"], "mu": opt_state["mu"],
                 "nu": opt_state["nu"], "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
