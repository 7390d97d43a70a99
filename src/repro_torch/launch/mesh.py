"""Meshes of processes, and the launcher that starts one process per slot.

Port of ``repro.launch.mesh``.  A ``DeviceMesh`` has the reference mesh's
``axis_names`` and ``shape`` (a dict, axis name -> size), which is all the
partition rules read.  ``make_test_mesh`` and ``make_production_mesh``
return descriptions: no process, no group.  ``DeviceMesh.bind`` lays the
ranks of a process group out row-major over the axes, as a JAX mesh lays
out its devices (rank = data * model_size + model on a ``("data",
"model")`` mesh), and creates one subgroup per axis; the bound mesh also
knows this rank's coordinates.

``run_world`` starts ``world`` processes with ``torch.multiprocessing``
(spawn), which rendezvous through a ``FileStore`` in a temporary directory;
``join_world`` joins a world that ``torchrun`` started.  The backend
follows one rule (``backend_for``): ``nccl`` when every rank has a CUDA
device of its own, ``gloo`` when ranks share a card and on the CPU.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class DeviceMesh:
    """Named axes of a grid of processes; bound to a process group or not.

    Unbound, only the sizes are known, and an axis of size 1 has coordinate
    0.  Bound (``bind``), ``coord(axis)`` is this rank's index along
    ``axis`` and ``group(axis)`` the ranks that differ from it only there;
    ``world`` is the whole group."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 coords: Optional[Sequence[int]] = None,
                 groups: Optional[Dict[str, Any]] = None, world=None):
        if len(axis_names) != len(sizes) or any(s < 1 for s in sizes):
            raise ValueError(f"bad mesh {axis_names} x {sizes}")
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        self.coords = None if coords is None else tuple(coords)
        self.groups = groups
        self.world = world

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def bound(self) -> bool:
        return self.coords is not None

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        if self.axis_size(axis) == 1:
            return 0
        if not self.bound:
            raise ValueError(f"axis {axis!r} of {self} has "
                             f"{self.axis_size(axis)} slots and the mesh is "
                             f"not bound to a process group (DeviceMesh.bind)")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        self.coord(axis)
        return self.groups[axis]

    def bind(self, group=None) -> "DeviceMesh":
        """This rank's view of the mesh over ``group`` (default: the whole
        world), whose size must equal the mesh's.  Collective: every rank of
        the group calls it, in the same order (it creates the subgroups)."""
        group = group or dist.group.WORLD
        ranks = dist.get_process_group_ranks(group)
        if len(ranks) != self.size:
            raise ValueError(f"a mesh of {self.shape} needs {self.size} "
                             f"ranks, the group has {len(ranks)}")
        grid = np.asarray(ranks).reshape(self.sizes)
        me = ranks.index(dist.get_rank())
        coords = np.unravel_index(me, self.sizes)
        groups = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.sizes[i])
            for line in lines:
                g = dist.new_group(line.tolist())
                if ranks[me] in line:
                    groups[axis] = g
        return DeviceMesh(self.axis_names, self.sizes,
                          tuple(int(c) for c in coords), groups, group)

    def __repr__(self) -> str:
        where = f" at {dict(zip(self.axis_names, self.coords))}" \
            if self.bound else ""
        return f"DeviceMesh({self.shape}{where})"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 chips) or 2x16x16 (2 pods, 512 chips): a
    description, with no process behind it."""
    if multi_pod:
        return DeviceMesh(("pod", "data", "model"), (2, 16, 16))
    return DeviceMesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    return DeviceMesh(("data", "model"), (data, model))


def as_mesh(mesh) -> Optional[DeviceMesh]:
    """A ``DeviceMesh`` as given; the engine's ``Mesh(model, data)``
    description (``.model``, ``.data``) as the same test mesh; None."""
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    return make_test_mesh(mesh.data, mesh.model)


def dp_axes(mesh) -> tuple:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def dp_size(mesh) -> int:
    s = 1
    for n in dp_axes(mesh):
        s *= mesh.shape[n]
    return s


def tp_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


# --------------------------------------------------------------------------- #
# one process per mesh slot
# --------------------------------------------------------------------------- #

def backend_for(device: torch.device, world: int) -> str:
    """``nccl`` when every rank has a CUDA device of its own; ``gloo`` when
    ranks share a card (NCCL refuses two ranks on one device) and on the
    CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: its own card where there are enough, else
    they share them in turn; the CPU stays the CPU."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def _world_entry(rank: int, fn: Callable, world: int, store: str,
                 backend: str, device: torch.device, args: tuple) -> None:
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, device, *args) -> str:
    """Run ``fn(rank, device, *args)`` in ``world`` spawned processes, one
    per mesh slot, joined into one process group; returns the backend.

    ``fn`` must be importable (a module-level function).  Raises when any
    process fails (``torch.multiprocessing``'s ``ProcessRaisedException``
    or ``ProcessExitedException``); the others are then terminated."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    backend = backend_for(device, world)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_world_entry, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, os.path.join(d, "store"),
                                 backend, device, args))
    return backend


def join_world(device) -> Tuple[int, torch.device, str]:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``PORT``) unless
    this process already belongs to one; returns (rank, device, backend)."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if not dist.is_initialized():
        backend = backend_for(device, int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])))
        dev = rank_device(device, local)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://")
    dev = rank_device(device, local)
    return dist.get_rank(), dev, dist.get_backend()


def in_world() -> bool:
    """Whether this process belongs to a world or ``torchrun`` started it."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


__all__ = ["DeviceMesh", "as_mesh", "backend_for", "dp_axes", "dp_size",
           "in_world", "join_world", "make_production_mesh",
           "make_test_mesh", "rank_device", "run_world", "tp_size"]
