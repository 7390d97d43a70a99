"""Checkpoints: ``repro.checkpoint.store`` without JAX or ml_dtypes.

A *manifest directory* is a directory of ``.npy`` files plus a
``manifest.json`` recording name/file/shape/dtype/crc32 per array and
arbitrary JSON ``extra`` metadata.  Writes go to ``<dir>.tmp`` and are
renamed into place after the manifest is fsynced, so a crash mid-write never
corrupts the latest good artifact.  The format is the reference's byte for
byte, so a directory either package writes, the other reads.

Numpy has no bfloat16 or float8 types.  The reference stores such arrays as
raw void records (``V2`` for bf16, ``V1`` for fp8) and records the logical
dtype (``"bfloat16"``, ``"float8_e4m3fn"``, ``"float8_e5m2"``) in the
manifest; here they travel as their raw bits, in the unsigned integer of the
same width, and the writer takes their logical dtype in a side mapping
(``dtypes``).  The reader hands them back as raw bits too.

On top of it sit the tree checkpoints (``save_checkpoint``,
``load_checkpoint``, ``CheckpointManager``), in the reference's files: a
tree is saved in the reference's layout (``convert.reference_layout``: an
``nn.Module`` or a mapping of ``state_dict`` names becomes the reference's
nested tree, layers stacked on a leading axis), its leaves in
``jax.tree_util`` order (dict keys sorted) under the same ``keystr`` paths,
bf16 leaves as raw bits.  So a checkpoint either package writes, the other
restores.  Restoring copies into the tensors of ``tree_like`` (a module's
parameters, an optimizer state's tensors) in place, on their devices.

In a sharded world (a ``CheckpointManager`` given ``shardings``: a tree
like the saved one whose named groups map ``state_dict`` names to
``launch.partition.NamedSharding``s) a save gathers host-complete arrays,
leaf by leaf on every rank, and rank 0 writes them: the files a one-device
save of the same weights writes.  A load with ``target_shardings`` makes
each rank read its own slices (the arrays memory-mapped, each checked
whole against its crc) into tensors of its slices' shapes.

Layout of one checkpoint:

    <dir>/step_<N>/
        manifest.json          # tree structure, shapes, dtypes, leaf files, crc
        leaf_00000.npy ...     # one .npy per leaf (host-local full arrays)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import Stacked, reference_layout
from ..launch import partition
from ..models.sharding import barrier

#: logical name of each narrow float dtype -> the numpy type of its raw bits
NARROW_DTYPES = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
}


def write_manifest_dir(final: str, arrays: Mapping[str, np.ndarray],
                       extra: Optional[Dict] = None,
                       dtypes: Optional[Mapping[str, str]] = None) -> str:
    """Atomically write named arrays + JSON metadata as a manifest directory.

    Each array lands as ``<name>.npy`` with its crc32 recorded in
    ``manifest.json``; the whole directory is staged at ``<final>.tmp`` and
    renamed into place after the manifest is fsynced.  ``dtypes`` names the
    logical dtype of arrays handed over as raw bits (a key of
    ``NARROW_DTYPES``); each such array must hold that dtype's raw-bits
    type.  Array names must be filesystem-safe.
    """
    dtypes = dict(dtypes or {})
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"arrays": [], "extra": extra or {}}
    for name, value in arrays.items():
        arr = np.asarray(value)
        fname = f"{name}.npy"
        dtype = dtypes.pop(name, None)
        disk = arr
        if dtype is not None:
            bits = NARROW_DTYPES.get(dtype)
            if bits is None or arr.dtype != bits:
                raise ValueError(
                    f"{name}: logical dtype {dtype!r} needs its raw bits as "
                    f"{np.dtype(bits).name if bits else 'a known type'}, "
                    f"got {arr.dtype}")
            # raw void records, as the reference writes extended dtypes
            disk = arr.view(f"V{arr.dtype.itemsize}")
        np.save(os.path.join(tmp, fname), disk)
        manifest["arrays"].append({
            "name": name, "file": fname, "shape": list(arr.shape),
            "dtype": dtype or str(arr.dtype),
            "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    if dtypes:
        raise ValueError(f"dtypes names arrays not written: {sorted(dtypes)}")
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def read_manifest_dir(path: str, verify: bool = True
                      ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load a manifest directory back as ``(arrays, extra)``.

    Narrow float arrays (void records whose manifest dtype is a key of
    ``NARROW_DTYPES``) come back as their raw bits; ``verify`` checks every
    crc and raises ``IOError`` on corruption.
    """
    manifest = _manifest(path)
    arrays: Dict[str, np.ndarray] = {}
    for rec in manifest["arrays"]:
        arr = np.load(os.path.join(path, rec["file"]))
        if arr.dtype.kind == "V" and rec["dtype"] in NARROW_DTYPES:
            arr = arr.view(NARROW_DTYPES[rec["dtype"]])
        if verify and (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != rec["crc"]:
            raise IOError(f"crc mismatch in {rec['file']} ({rec['name']})")
        arrays[rec["name"]] = arr
    return arrays, manifest.get("extra", {})


def _manifest(path: str) -> Dict:
    """A manifest directory's ``manifest.json``, a legacy tree manifest
    rewritten into the current layout."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "arrays" not in manifest and "leaves" in manifest:
        # legacy checkpoint manifest (pre-manifest-layer format): same
        # per-record fields under "leaves", tree metadata at top level
        manifest = {
            "arrays": [{**rec, "name": rec["file"][:-len(".npy")]}
                       for rec in manifest["leaves"]],
            "extra": {"step": manifest["step"],
                      "n_leaves": manifest["n_leaves"],
                      "paths": [rec["path"] for rec in manifest["leaves"]],
                      "extra": manifest.get("extra", {})},
        }
    return manifest


def manifest_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))


# --------------------------------------------------------------------------- #
# tree checkpoints
# --------------------------------------------------------------------------- #

#: torch's narrow float dtypes -> their logical names (keys of NARROW_DTYPES)
_TORCH_NARROW = {
    torch.bfloat16: "bfloat16",
    torch.float8_e4m3fn: "float8_e4m3fn",
    torch.float8_e5m2: "float8_e5m2",
}
_NARROW_TORCH = {name: dt for dt, name in _TORCH_NARROW.items()}


def _layout(tree):
    """The reference's layout of a tree: a module or a mapping with dotted
    (``state_dict``) names goes through ``reference_layout``; other
    mappings recurse; anything else is a leaf."""
    if isinstance(tree, nn.Module):
        return reference_layout(dict(tree.named_parameters()))
    if isinstance(tree, Mapping):
        if any("." in str(k) for k in tree):
            return reference_layout(tree)
        return {k: _layout(v) for k, v in tree.items()}
    return tree


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` in ``jax.tree_util`` order: dict keys
    sorted, None an empty subtree; a ``Stacked`` list is one leaf."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif node is not None:
            out.append((path, node))

    walk(_layout(tree), "")
    return out


def _tree_paths(tree) -> List[str]:
    return [path for path, _ in _flatten(tree)]


def _host(leaf, snapshot: bool):
    """A leaf on the host: a CPU tensor for tensors (a ``Stacked`` leaf
    stacked into one), else a numpy array.  ``snapshot`` copies even what
    is already on the host, so later in-place updates cannot reach it."""
    if isinstance(leaf, Stacked):
        out = torch.empty((len(leaf),) + tuple(leaf[0].shape),
                          dtype=leaf[0].dtype)
        for i, x in enumerate(leaf):
            out[i].copy_(x.detach())
        return out
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=snapshot)
    return np.array(leaf) if snapshot else np.asarray(leaf)


def _host_tree(tree) -> Dict:
    """A snapshot of ``tree`` on the host, in the reference's layout."""
    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return None if node is None else _host(node, snapshot=True)

    return walk(_layout(tree))


def _to_disk(arr) -> Tuple[np.ndarray, Optional[str]]:
    """(numpy array, logical dtype of raw bits or None) of a host leaf."""
    if isinstance(arr, torch.Tensor):
        name = _TORCH_NARROW.get(arr.dtype)
        if name is not None:
            bits = torch.int16 if arr.element_size() == 2 else torch.uint8
            return arr.view(bits).numpy().view(NARROW_DTYPES[name]), name
        return arr.numpy(), None
    return np.asarray(arr), None


def _manifest_dtypes(path: str) -> Dict[str, str]:
    """Each array's logical dtype, as its manifest records it."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "arrays" in manifest:
        return {rec["name"]: rec["dtype"] for rec in manifest["arrays"]}
    return {rec["file"][:-len(".npy")]: rec["dtype"]
            for rec in manifest["leaves"]}


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array as a CPU tensor of its logical dtype."""
    if dtype in _NARROW_TORCH:
        bits = np.int16 if arr.dtype.itemsize == 2 else np.uint8
        return torch.from_numpy(arr.view(bits)).view(_NARROW_TORCH[dtype])
    return torch.from_numpy(arr)


def _mesh(shardings):
    """The mesh of the first ``NamedSharding`` in a tree."""
    for v in shardings.values():
        return v.mesh if isinstance(v, partition.NamedSharding) else _mesh(v)


def _writer(mesh) -> bool:
    return all(mesh.coord(a) == 0 for a in mesh.axis_names)


def _is_named(shard) -> bool:
    return isinstance(shard, Mapping) and bool(shard) and all(
        isinstance(v, partition.NamedSharding) for v in shard.values())


def _named(node) -> Dict[str, torch.Tensor]:
    if isinstance(node, nn.Module):
        return dict(node.named_parameters())
    return dict(node)


def _gather_host(tree, shardings):
    """The whole of a sharded tree on the host of rank 0 (None on the
    others), gathered one leaf of the reference's tree at a time.
    Collective: every rank calls it, with trees of the same structure."""
    mesh = _mesh(shardings)
    writer = _writer(mesh)

    def walk(node, shard):
        if _is_named(shard):
            specs = {n: s.spec for n, s in shard.items()}
            out = {}
            for part in partition.iter_gathered(_named(node), specs, mesh):
                if writer:
                    out.update({n: t.detach().to("cpu", copy=True)
                                for n, t in part.items()})
            return out
        if isinstance(shard, Mapping):
            return {k: walk(node[k], shard[k]) for k in shard}
        full = partition.gather_named({"x": node}, {"x": shard.spec},
                                      mesh)["x"]
        return full.detach().to("cpu", copy=True) if writer else None

    host = walk(tree, shardings)
    return host if writer else None


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Blocking atomic save.  Returns the final checkpoint path."""
    leaves = _flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    arrays, dtypes = {}, {}
    for i, (_, leaf) in enumerate(leaves):
        arr, dtype = _to_disk(_host(leaf, snapshot=False))
        arrays[f"leaf_{i:05d}"] = arr
        if dtype is not None:
            dtypes[f"leaf_{i:05d}"] = dtype
    meta = {"step": step, "n_leaves": len(leaves),
            "paths": [path for path, _ in leaves], "extra": extra or {}}
    return write_manifest_dir(final, arrays, meta, dtypes=dtypes)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if manifest_exists(os.path.join(directory, name)):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def _leaf_shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, Stacked):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _targets(node, shard, prefix: str = ""):
    """(file path, layer index or None, tensor, NamedSharding) of every
    tensor of a sharded ``tree_like``."""
    if _is_named(shard):
        for name, t in _named(node).items():
            where = partition.layer_of(name)
            keys = name.split(".")
            if where is not None:
                keys = keys[:1] + keys[2:]
            path = prefix + "".join(f"[{k!r}]" for k in keys)
            yield path, None if where is None else where[1], t, shard[name]
    elif isinstance(shard, Mapping):
        for k in shard:
            yield from _targets(node[k], shard[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, None, node, shard


def _load_slices(path: str, tree_like, target_shardings, verify: bool):
    """Each tensor of ``tree_like`` receives its slice of the file's leaf
    (memory-mapped, so only what is copied is read beyond the crc check)."""
    manifest = _manifest(path)
    records = manifest["arrays"]
    paths = manifest["extra"]["paths"]
    index = {p: i for i, p in enumerate(paths)}
    loaded: Dict[int, np.ndarray] = {}
    for file_path, layer, like, ns in _targets(tree_like, target_shardings):
        if file_path not in index:
            raise ValueError(f"{file_path} is not in the checkpoint")
        i = index[file_path]
        rec = records[i]
        if i not in loaded:
            arr = np.load(os.path.join(path, rec["file"]), mmap_mode="r")
            if arr.dtype.kind == "V" and rec["dtype"] in NARROW_DTYPES:
                arr = arr.view(NARROW_DTYPES[rec["dtype"]])
            if verify and (zlib.crc32(arr) & 0xFFFFFFFF) != rec["crc"]:
                raise IOError(f"crc mismatch in {rec['file']} ({file_path})")
            loaded[i] = arr
        arr = loaded[i] if layer is None else loaded[i][layer]
        spec = ns.spec[1:] if layer is not None else ns.spec
        piece = arr[partition.slices(arr.shape, spec, ns.mesh)]
        if tuple(piece.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {file_path}: the slice is "
                             f"{piece.shape}, the tensor {tuple(like.shape)}")
        value = _from_disk(np.array(piece), rec["dtype"])
        if value.dtype != like.dtype:
            raise ValueError(f"dtype mismatch for {file_path}: "
                             f"{rec['dtype']} vs {like.dtype}")
        like.copy_(value)
    return tree_like


@torch.no_grad()
def load_checkpoint(directory: str, tree_like: Any, step: Optional[int] = None,
                    target_shardings: Any = None, verify: bool = True) -> Any:
    """Load into ``tree_like`` and return it.

    Its leaves must be tensors (a module's parameters, an optimizer state's
    tensors): each receives the checkpoint's values in place, on its own
    device, as ``load_state_dict`` does.  The leaf count, every path,
    shape and dtype must match the file's.  With ``target_shardings`` (a
    tree of ``NamedSharding``s like ``tree_like``, whose tensors are this
    rank's slices) each tensor receives its slice of the file's leaf."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if target_shardings is not None:
        return _load_slices(path, tree_like, target_shardings, verify)
    arrays, meta = read_manifest_dir(path, verify=verify)
    dtypes = _manifest_dtypes(path)
    leaves = _flatten(tree_like)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, expected {len(leaves)}")
    for i, ((tree_path, like), file_path) in enumerate(
            zip(leaves, meta["paths"])):
        if tree_path != file_path:
            raise ValueError(f"leaf {i} is {file_path} in the checkpoint, "
                             f"{tree_path} in the tree")
        targets = like if isinstance(like, Stacked) else [like]
        if not all(isinstance(t, torch.Tensor) for t in targets):
            raise TypeError(f"{tree_path}: restores into tensors only, got "
                            f"{type(targets[0]).__name__}")
        name = f"leaf_{i:05d}"
        arr = arrays[name]
        if tuple(arr.shape) != _leaf_shape(like):
            raise ValueError(f"shape mismatch for {tree_path}: {arr.shape} "
                             f"vs {_leaf_shape(like)}")
        value = _from_disk(arr, dtypes[name])
        if value.dtype != targets[0].dtype:
            raise ValueError(f"dtype mismatch for {tree_path}: "
                             f"{dtypes[name]} vs {targets[0].dtype}")
        if isinstance(like, Stacked):
            for t, v in zip(like, value):
                t.copy_(v)
        else:
            like.copy_(value)
    return tree_like


class CheckpointManager:
    """Async single-writer checkpoint manager with retention.

    With ``shardings`` (the trees' layout in a sharded world) every rank
    calls every method in the same order: saves gather on the caller's
    thread and rank 0 writes; ``wait``, ``latest_step`` and ``restore``
    first wait for rank 0's write to land, and restores read this rank's
    slices unless given other ``target_shardings``."""

    def __init__(self, directory: str, keep: int = 3, shardings: Any = None):
        self.directory = directory
        self.keep = keep
        self.shardings = shardings
        self._mesh = None
        if shardings is not None and _mesh(shardings).size > 1:
            self._mesh = _mesh(shardings)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            barrier(self._mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def async_save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """The copy to the host happens on the caller's thread (a
        consistent snapshot; in a sharded world, the collective gather, in
        the same order on every rank); file I/O runs in the background."""
        self.wait()
        if self._mesh is not None:
            host_tree = _gather_host(tree, self.shardings)
            if host_tree is None:
                return
        else:
            host_tree = _host_tree(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        self.wait()
        if self._mesh is not None:
            host = _gather_host(tree, self.shardings)
            if host is not None:
                save_checkpoint(self.directory, step, host, extra)
                self._gc()
            barrier(self._mesh)
            return os.path.join(self.directory, f"step_{step:08d}")
        p = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return p

    def restore(self, tree_like: Any, step: Optional[int] = None,
                target_shardings: Any = None) -> Any:
        self.wait()
        return load_checkpoint(self.directory, tree_like, step,
                               target_shardings or self.shardings)

    def latest_step(self) -> Optional[int]:
        if self._mesh is not None:
            self.wait()
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
