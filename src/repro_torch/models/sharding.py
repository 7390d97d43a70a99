"""Logical-axis sharding helpers and the collectives the layers run.

Port of ``repro.models.sharding``.  The logical axes (dp = batch, tp =
tensor/model parallel) are thread-local, as in the reference; ``shard`` is
a no-op, because here every placement is explicit: a rank holds its own
slice of each parameter (``launch.partition``) and the layers call the
collectives below where GSPMD would insert them.

Each collective is a ``torch.autograd.Function`` whose backward is stated,
over one axis of a bound ``launch.mesh.DeviceMesh`` (an axis of size 1, or
no mesh, makes it the identity):

  * ``reduce_from``: all_reduce (sum) forward, identity backward — the sum of
    partial products (a row-parallel product, a masked lookup);
  * ``copy_to``: identity forward, all_reduce backward — the input of a
    column-parallel product, or a replicated leaf used on per-rank data;
  * ``all_gather``: forward along a dim, reduce-scatter backward (``mean``
    divides it by the axis size, for a leaf every rank then uses alike);
  * ``scatter_seq`` / ``gather_seq``: keep this rank's slice of a dim /
    gather the slices back (backward: all-gather / keep the slice);
  * ``all_to_all``: ``all_to_all_single`` over dim 0, its own inverse.

The raw collectives count calls and bytes in ``STATS``.  Where the group's
backend is ``gloo`` and the tensor is on a card, a collective outside
``GLOO_CUDA`` takes a host round trip (copy out, collective on the CPU,
copy back), fixed here by name and counted in ``STATS.host_staged_bytes``.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

_state = threading.local()


def set_mesh_axes(dp: Tuple[str, ...] = ("data",), tp: Optional[str] = "model"):
    _state.dp = tuple(dp)
    _state.tp = tp


def axes_from_mesh(mesh) -> None:
    names = mesh.axis_names
    dp_ = tuple(n for n in names if n in ("pod", "data", "replica"))
    tp_ = "model" if "model" in names else None
    set_mesh_axes(dp_ or ("data",), tp_)


def set_mesh(mesh) -> None:
    """The mesh ``tp_size`` and ``div_or_none`` read when given none (the
    reference reads the abstract mesh that ``set_mesh`` installs)."""
    _state.mesh = mesh


def _current_mesh():
    return getattr(_state, "mesh", None)


def dp() -> Union[Tuple[str, ...], str, None]:
    d = getattr(_state, "dp", ("data",))
    if len(d) == 1:
        return d[0]
    return d


def tp() -> Optional[str]:
    return getattr(_state, "tp", "model")


def shard(x, *spec):
    """A no-op: placement is explicit in the port."""
    return x


def _shape(mesh):
    """The mesh's axis sizes as a dict; the engine's ``Mesh(model, data)``
    reads as ``{"model": model, "data": data}``."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return shape
    return {"model": mesh.model, "data": mesh.data}


def tp_size(mesh=None) -> int:
    m = mesh or _current_mesh()
    if m is None or tp() is None:
        return 1
    return _shape(m).get(tp(), 1)


def div_or_none(n: int, axis_name: Optional[str], mesh=None):
    """Return axis_name if it divides n on the active mesh, else None.

    Used for dims that are only sometimes shardable (e.g. kv heads < tp)."""
    if axis_name is None:
        return None
    m = mesh or _current_mesh()
    if m is None:
        return axis_name
    size = _shape(m).get(axis_name)
    if size is None:
        return None
    return axis_name if n % size == 0 and n >= size else None


# --------------------------------------------------------------------------- #
# raw collectives (counted)
# --------------------------------------------------------------------------- #

#: collectives ``gloo`` takes on CUDA tensors (torch 2.11 on the H100, probed
#: by ``chip_smoke.py`` phase 11); the others take a host round trip on a
#: ``gloo`` group.  Its point-to-point ops hand a CUDA tensor's device
#: pointer to the TCP transport, whose ``writev`` fails: raised in the
#: caller, or, when gloo's own thread writes, an abort of the process
GLOO_CUDA = frozenset({"all_reduce", "all_gather_into_tensor",
                       "reduce_scatter_tensor", "all_to_all_single"})


class CollectiveStats:
    """Calls and bytes (each rank's input) per collective, and the bytes a
    host round trip moved (out and back)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.host_staged_bytes = 0

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "host_staged_bytes": self.host_staged_bytes}


STATS = CollectiveStats()

_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _staged(name: str, group, x: torch.Tensor) -> bool:
    return (x.is_cuda and name not in GLOO_CUDA
            and dist.get_backend(group) == "gloo")


def _buffers(name: str, group, x: torch.Tensor, out_numel: int):
    """Count a call of ``name``: (``x`` contiguous, a fresh flat output of
    ``out_numel`` elements, staged), both on the host where ``_staged``."""
    STATS.calls[name] += 1
    STATS.bytes[name] += x.numel() * x.element_size()
    staged = _staged(name, group, x)
    inp = (x.detach().to("cpu") if staged else x.detach()).contiguous()
    if staged:
        STATS.host_staged_bytes += (inp.numel() + out_numel) * x.element_size()
    out = torch.empty(out_numel, dtype=x.dtype, device=inp.device)
    return inp, out, staged


def _run(name: str, group, x: torch.Tensor, out_numel: int, call):
    """``call(out, inp)`` on ``_buffers``; the output back on ``x``'s
    device."""
    inp, out, staged = _buffers(name, group, x, out_numel)
    call(out, inp)
    return out.to(x.device) if staged else out


def _size(mesh, axis) -> int:
    return 1 if mesh is None else _shape(mesh).get(axis, 1)


def reduce_(x: torch.Tensor, mesh, axis: str = "model",
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    """all_reduce over ``axis``; a new tensor of ``x``'s shape."""
    if _size(mesh, axis) == 1:
        return x.clone()

    def call(out, inp):
        out.copy_(inp.reshape(-1))
        dist.all_reduce(out, op=op, group=mesh.group(axis))

    return _run("all_reduce", mesh.group(axis), x, x.numel(),
                call).view(x.shape)


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """all_gather over ``axis``, the slices concatenated along ``dim`` in
    rank order."""
    n = _size(mesh, axis)
    if n == 1:
        return x.clone()
    out = _run("all_gather_into_tensor", mesh.group(axis), x, n * x.numel(),
               lambda o, i: _all_gather_flat(o, i.reshape(-1),
                                             group=mesh.group(axis)))
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """Sum over ``axis``, keeping this rank's slice of ``dim``."""
    n = _size(mesh, axis)
    if n == 1:
        return x.clone()
    chunks = torch.stack(x.chunk(n, dim=dim))
    out = _run("reduce_scatter_tensor", mesh.group(axis), chunks,
               chunks[0].numel(),
               lambda o, i: _reduce_scatter_flat(o, i.reshape(-1),
                                                 group=mesh.group(axis)))
    return out.view(chunks.shape[1:])


def all_to_all_(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``all_to_all_single``: chunk i of dim 0 goes to rank i, and chunk i
    of the result came from rank i."""
    if _size(mesh, axis) == 1:
        return x.clone()
    return _run("all_to_all_single", mesh.group(axis), x, x.numel(),
                lambda o, i: dist.all_to_all_single(
                    o, i.reshape(-1), group=mesh.group(axis))).view(x.shape)


class _Ring:
    """A ring exchange in flight: ``wait()`` gives the received tensor."""

    def __init__(self, reqs, out, like, sent):
        # ``sent`` stays referenced until the send has completed
        self.reqs, self.out, self.like, self.sent = reqs, out, like, sent

    def wait(self) -> torch.Tensor:
        for req in self.reqs:
            req.wait()
        return self.out.to(self.like.device).view(self.like.shape)


def ring_start(x: torch.Tensor, mesh, axis: str = "model") -> _Ring:
    """Start sending ``x`` to the next rank along ``axis`` and receiving
    the previous rank's (``batch_isend_irecv``); returns at once."""
    n = _size(mesh, axis)
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.coord(axis)
    inp, out, _ = _buffers("batch_isend_irecv", group, x, x.numel())
    ops = [dist.P2POp(dist.isend, inp.reshape(-1), ranks[(me + 1) % n],
                      group),
           dist.P2POp(dist.irecv, out, ranks[(me - 1) % n], group)]
    return _Ring(dist.batch_isend_irecv(ops), out, x, inp)


def barrier(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.world)


# --------------------------------------------------------------------------- #
# autograd-aware collectives
# --------------------------------------------------------------------------- #

class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return reduce_(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, mean):
        ctx.mesh, ctx.axis, ctx.dim, ctx.mean = mesh, axis, dim, mean
        return gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim)
        if ctx.mean:
            out = out / ctx.mesh.axis_size(ctx.axis)
        return out, None, None, None, None


def _local(x, mesh, axis, dim):
    n = mesh.axis_size(axis)
    return x.chunk(n, dim=dim)[mesh.coord(axis)]


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _local(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_local(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all_(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_(g, ctx.mesh, ctx.axis), None, None


def _active(mesh, axis) -> bool:
    """Whether ``axis`` has more than one slot; raises when it has and the
    mesh is not bound to a process group."""
    if _size(mesh, axis) == 1:
        return False
    if not getattr(mesh, "bound", False):
        raise ValueError(f"{mesh} has {_size(mesh, axis)} {axis!r} slots and "
                         f"is not bound to a process group: bind a "
                         f"DeviceMesh (launch.mesh) in each rank's process")
    return True


def reduce_from(x, mesh, axis: str = "model"):
    """Sum of per-rank partials; the backward hands the gradient on."""
    return _ReduceFrom.apply(x, mesh, axis) if _active(mesh, axis) else x


def copy_to(x, mesh, axis: str = "model"):
    """``x`` itself; the backward sums the per-rank gradients."""
    return _CopyTo.apply(x, mesh, axis) if _active(mesh, axis) else x


def all_gather(x, mesh, axis: str = "model", dim: int = 0,
               mean: bool = False):
    """The slices of ``x`` gathered along ``dim``; the backward
    reduce-scatters the gradient (divided by the axis size with ``mean``:
    for a leaf that every rank then uses alike, whose gradients are equal
    on every rank)."""
    return _AllGather.apply(x, mesh, axis, dim, mean) \
        if _active(mesh, axis) else x


def scatter_seq(x, mesh, axis: str = "model", dim: int = 1):
    """This rank's slice of a replicated ``x`` along ``dim``."""
    return _ScatterSeq.apply(x, mesh, axis, dim) if _active(mesh, axis) else x


def gather_seq(x, mesh, axis: str = "model", dim: int = 1):
    """The slices gathered back along ``dim``, for replicated use after."""
    return _GatherSeq.apply(x, mesh, axis, dim) if _active(mesh, axis) else x


def all_to_all(x, mesh, axis: str = "model"):
    return _AllToAll.apply(x, mesh, axis) if _active(mesh, axis) else x


def axis_index(mesh, axis: str = "model") -> int:
    return mesh.coord(axis) if _active(mesh, axis) else 0


def axis_size(mesh, axis: str = "model") -> int:
    return _size(mesh, axis)
