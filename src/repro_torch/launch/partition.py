"""Parameter / optimizer / cache / batch partition rules, and the slices
each rank keeps.

Port of ``repro.launch.partition``: Megatron-style TP over the ``model``
axis, DP over (``pod``, ``data``), expert-parallel MoE weights over
``model``, vocab-sharded embeddings, and ZeRO-1-style extra data-axis
sharding on optimizer-state leaves.  Dims that are only conditionally
shardable fall back to replication by the same divisibility rule.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
axis names (one dim over several axes, major first) or None.  Spec trees
are keyed by ``state_dict`` names.  The reference's rules take a *stacked*
leaf ``[L, ...]`` for a layer stack; the port's layers are unstacked
(``layers.3.attn.wq``), and the spec of such a name is the reference's
spec of the stacked leaf, leading layer entry included: None for every
parameter, but the ZeRO rule may split the layer axis over ``data``
(``opt_specs``), and then a data rank owns whole layers of the optimizer
state.  ``local_shard`` cuts one rank's contiguous slice; ``shard_named``,
``gather_named`` and ``reduce_named`` apply a spec tree to
``{name: tensor}`` state, stacking the layers of a stack where the layer
axis is split.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

from ..models.layers import window_leaf
from ..models.sharding import div_or_none, gather, reduce_, reduce_scatter
from .mesh import dp_axes, dp_size

#: ``state_dict`` prefixes whose leaves the reference stacks on [L, ...]
STACKS = ("layers", "enc_layers", "dec_layers")

Spec = Tuple[Any, ...]


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def layer_of(name: str) -> Optional[Tuple[str, int, str]]:
    """``layers.3.attn.wq`` -> ("layers", 3, "attn.wq"); None outside the
    layer stacks."""
    parts = name.split(".")
    if parts[0] in STACKS and len(parts) > 2 and parts[1].isdigit():
        return parts[0], int(parts[1]), ".".join(parts[2:])
    return None


def _div(mesh, axis: Optional[str], n: int) -> Optional[str]:
    # one divisibility rule for the whole tree: the shared helper in
    # repro_torch.models.sharding (argument order flipped for the rule table)
    return div_or_none(n, axis, mesh)


def param_spec(mesh, name: str, shape: Sequence[int]) -> Spec:
    """Spec of the parameter ``name`` of (unstacked) ``shape``; a name in a
    layer stack gets the stacked leaf's spec, led by None."""
    leaf = _leaf_name(name)
    stacked = layer_of(name) is not None
    core = tuple(shape)
    tp = "model" if "model" in mesh.axis_names else None

    def spec(*axes):
        return ((None,) if stacked else ()) + tuple(axes)

    nd = len(core)
    if leaf == "embed":
        return spec(_div(mesh, tp, core[0]), None)
    if leaf == "unembed":
        return spec(None, _div(mesh, tp, core[1]))
    if leaf in ("wq", "wk", "wv"):
        return spec(None, _div(mesh, tp, core[1]))
    if leaf == "wo":
        return spec(_div(mesh, tp, core[0]), None)
    if leaf in ("up", "gate"):
        if nd == 3:   # MoE experts [E, d, f] — expert parallel
            return spec(_div(mesh, tp, core[0]), None, None)
        return spec(None, _div(mesh, tp, core[1]))
    if leaf == "down":
        if nd == 3:
            return spec(_div(mesh, tp, core[0]), None, None)
        return spec(_div(mesh, tp, core[0]), None)
    if leaf == "router":
        return spec(None, None)
    if leaf == "in_proj":
        return spec(None, _div(mesh, tp, core[1]))
    if leaf == "out_proj":
        return spec(_div(mesh, tp, core[0]), None)
    if leaf in ("conv", "conv_bias"):
        return spec(*([None] * (nd - 1) + [_div(mesh, tp, core[-1])]))
    # norms, biases, scalars: replicate
    return spec(*([None] * nd))


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def params_specs(mesh, params) -> Dict[str, Spec]:
    """``{name: spec}`` of a module's parameters (or a name -> tensor
    mapping; meta tensors will do)."""
    return {n: param_spec(mesh, n, p.shape) for n, p in _named(params).items()}


def depths(names) -> Dict[str, int]:
    """Layers per stack, from the names of one tree."""
    out: Dict[str, int] = {}
    for name in names:
        where = layer_of(name)
        if where is not None:
            out[where[0]] = max(out.get(where[0], 0), where[1] + 1)
    return out


def _full_shape(name: str, shape, depth: Mapping[str, int]) -> Tuple[int, ...]:
    where = layer_of(name)
    return ((depth[where[0]],) if where else ()) + tuple(shape)


def _dp_entry(mesh):
    dpa = dp_axes(mesh)
    return dpa if len(dpa) > 1 else dpa[0]


def opt_specs(mesh, opt_shape, p_specs) -> Dict[str, Any]:
    """Optimizer-state specs: parameter spec + one extra data-axis dim
    (ZeRO-1) on the first free dim of the (stacked) leaf that divides."""
    dsz = dp_size(mesh)
    dpe = _dp_entry(mesh)
    out: Dict[str, Any] = {"step": ()}
    for key in ("master", "mu", "nu"):
        tree = opt_shape[key]
        depth = depths(tree)
        specs = {}
        for name, leaf in tree.items():
            shape = _full_shape(name, leaf.shape, depth)
            axes = list(p_specs.get(name, ()))
            axes += [None] * (len(shape) - len(axes))
            for i, ax in enumerate(axes):
                if ax is None and shape[i] % dsz == 0 and shape[i] >= dsz:
                    axes[i] = dpe
                    break
            specs[name] = tuple(axes)
        out[key] = specs
    return out


def batch_specs(mesh, batch_shape: Mapping[str, Any]) -> Dict[str, Spec]:
    dsz = dp_size(mesh)
    dpe = _dp_entry(mesh)

    def one(leaf):
        b = leaf.shape[0] if leaf.ndim else 1
        first = dpe if (b % dsz == 0 and b >= dsz) else None
        return tuple([first] + [None] * (leaf.ndim - 1))

    return {k: one(v) for k, v in batch_shape.items()}


def cache_specs(mesh, cfg, caches_shape) -> Any:
    """KV/SSM cache specs for decode: batch over dp when divisible, the long
    sequence window over ``model``, ssm heads over ``model`` when divisible.
    ``caches_shape``: the nested cache dicts (None subtrees stay None)."""
    dsz = dp_size(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    dp_ax = _dp_entry(mesh)

    def batch_ax(b):
        return dp_ax if b % dsz == 0 and b >= dsz else None

    def one(name, leaf):
        sh = leaf.shape
        if name == "pos" or leaf.ndim <= 1:
            return (None,) * leaf.ndim
        if name in ("k", "v", "k_scale", "v_scale"):
            # stacked [L(, G), B, S, K, hd|1] or unstacked [B, S, K, hd|1]
            lead = leaf.ndim - 4
            return tuple([None] * lead + [batch_ax(sh[lead]),
                                          _div(mesh, tp, sh[lead + 1]),
                                          None, None])
        if name == "state":
            # [..., B, H, P, N]
            lead = leaf.ndim - 4
            return tuple([None] * lead + [batch_ax(sh[lead]),
                                          _div(mesh, tp, sh[lead + 1]),
                                          None, None])
        if name == "conv":
            # [..., B, Kw-1, Ch]
            lead = leaf.ndim - 3
            return tuple([None] * lead + [batch_ax(sh[lead]), None,
                                          _div(mesh, tp, sh[lead + 2])])
        return (None,) * leaf.ndim

    def walk(node):
        return {k: (walk(v) if isinstance(v, Mapping) else
                    None if v is None else one(k, v))
                for k, v in node.items()}

    return walk(caches_shape)


def shard_caches(mesh, cfg, caches) -> Any:
    """This rank's slices of caches made whole (on one device: ``lm.prefill``
    and ``grow_caches``, ``encdec.make_dec_caches``) under ``cache_specs``,
    as new tensors; each attention cache carries its ``"window"`` leaf
    (``models.layers.kv_window``), so a decode step on ``mesh`` reads its
    layout, split or whole.  The counterpart of placing the reference's
    caches with ``cache_specs``' shardings."""
    specs = cache_specs(mesh, cfg, caches)

    def walk(node, spec):
        if node is None:
            return None
        if not isinstance(node, Mapping):
            return local_shard(node, spec, mesh).clone()
        out = {k: walk(v, spec[k]) for k, v in node.items()}
        if "k" in node and "window" not in node:
            k = node["k"]
            out["window"] = window_leaf(k.shape[-3], k.shape[:-4], k.device)
        return out

    return walk(caches, specs)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where one leaf's slices live (the counterpart of
    ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec


def to_named(mesh, spec_tree):
    """Every spec (a tuple) of a nested dict as a ``NamedSharding``."""
    if isinstance(spec_tree, Mapping):
        return {k: to_named(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


# --------------------------------------------------------------------------- #
# slices
# --------------------------------------------------------------------------- #

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _slot(mesh, entry) -> Tuple[int, int]:
    """(this rank's index, slot count) along a spec entry's axes (major
    first)."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * mesh.axis_size(a) + mesh.coord(a)
        n *= mesh.axis_size(a)
    return idx, n


def only(spec: Spec, axes: Optional[Sequence[str]]) -> Spec:
    """``spec`` with only the axes in ``axes`` (all when None)."""
    if axes is None:
        return tuple(spec)
    out = []
    for entry in spec:
        keep = tuple(a for a in _axes(entry) if a in axes)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(out)


def slices(shape: Sequence[int], spec: Spec, mesh) -> Tuple[slice, ...]:
    """This rank's contiguous slice of each dim of ``shape``."""
    out = []
    for dim, size in enumerate(shape):
        idx, n = _slot(mesh, spec[dim] if dim < len(spec) else None)
        out.append(slice(idx * (size // n), (idx + 1) * (size // n)))
    return tuple(out)


def local_shard(x, spec: Spec, mesh):
    """This rank's contiguous slice of ``x`` (a tensor or an array) under
    ``spec`` (a view)."""
    return x[slices(x.shape, spec, mesh)]


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in slices(shape, spec, mesh))


def owns(name: str, spec: Spec, mesh, depth: Mapping[str, int]) -> bool:
    """Whether this rank holds a slice of ``name``: outside a stack always;
    in one, when its layer falls in this rank's share of the layer axis."""
    where = layer_of(name)
    if where is None:
        return True
    idx, n = _slot(mesh, spec[0])
    per = depth[where[0]] // n
    return where[1] // per == idx


def leaf_spec(name: str, spec: Spec) -> Spec:
    """The spec of the unstacked leaf ``name`` (the layer entry dropped)."""
    return tuple(spec[1:]) if layer_of(name) else tuple(spec)


def shard_named(named: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                mesh, dtype=None, axes: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's slices of ``named`` along ``axes`` (default: every axis
    a spec names; the tensors are whole along the others) as new tensors
    (``dtype`` if given); names this rank holds nothing of are left out."""
    depth = depths(specs)
    out = {}
    for name, x in named.items():
        spec = only(specs[name], axes)
        if owns(name, spec, mesh, depth):
            out[name] = local_shard(x.detach(), leaf_spec(name, spec),
                                    mesh).to(dtype or x.dtype, copy=True)
    return out


def _groups(specs: Mapping[str, Spec]) -> Iterator[Tuple[List[str], Spec]]:
    """(names, spec) of each leaf of the reference's tree, in sorted
    order: the L names of a layer stack's leaf together."""
    stacks: Dict[Tuple[str, str], List[str]] = {}
    singles = []
    for name in specs:
        where = layer_of(name)
        if where is None:
            singles.append(name)
        else:
            stacks.setdefault((where[0], where[2]), []).append(name)
    keyed = [((n,), [n]) for n in singles]
    keyed += [(k, sorted(v, key=lambda n: layer_of(n)[1]))
              for k, v in stacks.items()]
    for _, names in sorted(keyed, key=lambda kv: kv[0]):
        yield names, specs[names[0]]


def _stack(local: Mapping[str, torch.Tensor], names: List[str], spec: Spec,
           mesh, depth) -> torch.Tensor:
    if layer_of(names[0]) is None:
        return local[names[0]]
    return torch.stack([local[n] for n in names
                        if owns(n, spec, mesh, depth)])


def _unstack(x: torch.Tensor, names: List[str], spec: Spec, mesh, depth
             ) -> Dict[str, torch.Tensor]:
    if layer_of(names[0]) is None:
        return {names[0]: x}
    mine = [n for n in names if owns(n, spec, mesh, depth)]
    return dict(zip(mine, x.unbind(0)))


def iter_gathered(local: Mapping[str, torch.Tensor],
                  specs: Mapping[str, Spec], mesh,
                  axes: Optional[Sequence[str]] = None
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """The slices in ``local`` gathered over ``axes`` (default: every axis
    a spec names), one leaf of the reference's tree at a time, on every
    rank: ``{name: tensor}``, each the slice its spec leaves over the other
    axes.  Collective: one all-gather per leaf and axis, in the same order
    on every rank."""
    depth = depths(specs)
    rest_axes = [] if axes is None else [a for a in mesh.axis_names
                                         if a not in axes]
    for names, spec in _groups(specs):
        x = _stack(local, names, spec, mesh, depth)
        for dim, entry in enumerate(only(spec, axes)):
            for a in reversed(_axes(entry)):
                x = gather(x, mesh, a, dim)
        yield _unstack(x, names, only(spec, rest_axes), mesh, depth)


def gather_named(local, specs, mesh, axes=None) -> Dict[str, torch.Tensor]:
    """``iter_gathered`` merged into one dict."""
    out: Dict[str, torch.Tensor] = {}
    for part in iter_gathered(local, specs, mesh, axes):
        out.update(part)
    return out


def reduce_named(full: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                 mesh, axes: Sequence[str], scatter: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """Sum ``full`` (every name, this rank's addend) over ``axes`` and keep
    this rank's slices along the dims ``specs`` splits over them: by a
    reduce-scatter (``scatter``), or an all-reduce and a local cut; a leaf
    not split over ``axes`` is all-reduced.  Collective, per leaf of the
    reference's tree."""
    depth = depths(specs)
    out = {}
    for names, spec in _groups(specs):
        x = full[names[0]] if layer_of(names[0]) is None \
            else torch.stack([full[n] for n in names])
        spec = only(spec, axes)
        done = set()
        if scatter:
            for dim, entry in enumerate(spec):
                for a in _axes(entry):
                    x = reduce_scatter(x, mesh, a, dim)
                    done.add(a)
        for a in axes:
            if a not in done:
                x = reduce_(x, mesh, a)
        if not scatter:
            x = local_shard(x, spec, mesh)
        out.update(_unstack(x, names, spec, mesh, depth))
    return out


def shard_module(model: nn.Module, specs: Mapping[str, Spec], mesh,
                 device=None) -> nn.Module:
    """Replace each parameter of ``model`` by this rank's slice (a new
    tensor; the full one can then be freed).  A parameter on the meta
    device becomes an uninitialized slice on ``device``."""
    for name, p in list(model.named_parameters()):
        spec = leaf_spec(name, specs[name])
        if p.is_meta:
            x = torch.empty(local_shape(p.shape, spec, mesh), dtype=p.dtype,
                            device=device)
        else:
            x = local_shard(p.detach(), spec, mesh).clone()
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, attr,
                nn.Parameter(x, requires_grad=p.requires_grad))
    return model


def opt_init(params, o_specs: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """``adamw_init``'s state holding only this rank's ZeRO slices: the
    master weights cut over the data axes from the (model-sharded)
    parameters, zero moments."""
    named = _named(params)
    master = shard_named(named, o_specs["master"], mesh, dtype=torch.float32,
                         axes=dp_axes(mesh))
    device = next(iter(named.values())).device
    return {"master": master,
            "mu": {n: torch.zeros_like(m) for n, m in master.items()},
            "nu": {n: torch.zeros_like(m) for n, m in master.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


__all__ = ["NamedSharding", "STACKS", "batch_specs", "cache_specs", "depths",
           "gather_named", "iter_gathered", "layer_of", "leaf_spec",
           "local_shape", "local_shard", "only", "opt_init", "opt_specs",
           "owns", "param_spec", "params_specs", "reduce_named",
           "shard_caches", "shard_module", "shard_named", "slices",
           "to_named"]
