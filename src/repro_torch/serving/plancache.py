"""Persistent, content-addressed store for compiled execution plans.

Port of ``repro.serving.plancache`` (single-device plans; the sharded
branches come with the sharding slice).  The offline cost — Theorem-1
scheduling plus Connection Reordering — is paid once per network, not once
per process:

  * the cache key is a sha256 over the *content* of the network (each
    layer's block pattern, weights, bias, tile shape) plus every engine
    setting that affects the schedule arrays (``reorder``, ``M_tiles``,
    ``reorder_iters``, ``seed``, ``policy``, ``fuse``, and ``max_move_span``
    / ``gate`` / ``weight_dtype`` when set) and the artifact format version;
    the string equals the reference's for the same net and settings, so the
    two packages share entries;
  * the stored artifact is the whole-DAG connection ``order`` (everything
    else re-derives from it deterministically), the flat-schedule arrays
    (to verify the rebuild bit for bit) and the plan's ``IOReport``,
    written through ``checkpoint``'s atomic manifest directories;
  * a hit calls ``Engine.compile_with_order``: zero annealer iterations, no
    I/O re-simulation, outputs bit-identical to the cold compile the order
    came from.  An entry that fails to load or whose arrays no longer match
    the rebuild is quarantined and treated as a miss, so stale caches
    self-heal.

Backend and activation are not part of the key: the connection order is
backend-independent and the activation only changes the epilogue.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..checkpoint.store import (
    manifest_exists,
    read_manifest_dir,
    write_manifest_dir,
)
from ..core.blocksparse import BlockFFNN, BSRLayer
from ..engine import Engine, ExecutionPlan, IOReport
from ..kernels.ops import resolve_weight_dtype
from ..obs.trace import NULL_TRACER

FORMAT_VERSION = 1

Net = Union[BlockFFNN, Sequence[BSRLayer]]


def _layers_of(net: Net):
    return net.layers if isinstance(net, BlockFFNN) else list(net)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded plans are not ported yet; the plan store keeps "
            "single-device plans only")


def layers_fingerprint(net: Net) -> str:
    """sha256 over every layer's structure AND weights.

    The schedule only depends on the block *pattern*, but keying on weights
    too means a repruned or retrained network can never silently serve a
    stale schedule-with-matching-shape.
    """
    h = hashlib.sha256()
    for lay in _layers_of(net):
        h.update(json.dumps([lay.n_in, lay.n_out, lay.block_m, lay.block_n,
                             lay.nnz_blocks]).encode())
        h.update(np.ascontiguousarray(lay.rows, dtype=np.int32).tobytes())
        h.update(np.ascontiguousarray(lay.cols, dtype=np.int32).tobytes())
        h.update(np.ascontiguousarray(lay.blocks).tobytes())
        h.update(np.ascontiguousarray(lay.bias).tobytes())
    return h.hexdigest()


def plan_cache_key(engine: Engine, net: Net, mesh=None) -> str:
    """Content-addressed key: layer hash + schedule-affecting settings.

    ``max_move_span`` / ``gate`` / ``weight_dtype`` enter the dict only when
    set (non-default), as in the reference, so f32 and quantized, gated and
    ungated plans of one net never alias.  ``mesh`` is kept for the sharding
    slice and raises ``NotImplementedError`` when given.
    """
    _no_mesh(mesh)
    settings = {
        "format": FORMAT_VERSION,
        "layers": layers_fingerprint(net),
        "reorder": bool(engine.reorder),
        "M_tiles": int(engine.M_tiles),
        "reorder_iters": int(engine.reorder_iters),
        "seed": int(engine.seed),
        "policy": engine.policy,
        "fuse": bool(engine.fuse),
    }
    if engine.max_move_span:
        settings["max_move_span"] = int(engine.max_move_span)
    if engine.gate:
        settings["gate"] = True
    wdt = resolve_weight_dtype(engine.weight_dtype)
    if wdt != "f32":
        settings["weight_dtype"] = wdt
    return hashlib.sha256(
        json.dumps(settings, sort_keys=True).encode()).hexdigest()


def _artifact_dtypes(plan: ExecutionPlan) -> dict:
    """Logical dtypes of the raw-bit arrays of ``plan.artifact_arrays()``:
    the quantized blocks (``torch.bfloat16`` -> ``"bfloat16"``)."""
    if plan.flat is None or plan.flat.scales is None:
        return {}
    return {"flat_qblocks": str(plan.flat.blocks.dtype).split(".")[-1]}


class PlanStore:
    """Directory of plan artifacts keyed by :func:`plan_cache_key`.

    ``fault_injector`` (a ``serving.resilience.FaultInjector``) fires the
    ``store.load`` chaos site inside the read path.  An entry that raises on
    load or fails its self-heal verify is moved to ``<root>/quarantine/``
    (counted in ``self.quarantined``) and treated as a miss; the recompile
    overwrites the live slot, so bad bytes are never retried in a loop.
    ``tracer`` records ``store.load`` / ``store.compile`` spans and
    ``store.quarantine`` events.
    """

    def __init__(self, root: str, fault_injector=None, tracer=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.injector = fault_injector
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.quarantined = 0
        # per-key in-process compile locks: two threads warm-starting the
        # same network serialize on the key, so the loser hits the entry
        # the winner just wrote instead of paying the annealing again
        self._locks_mu = threading.Lock()
        self._key_locks: dict = {}

    def _key_lock(self, key: str) -> threading.Lock:
        with self._locks_mu:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = self._key_locks[key] = threading.Lock()
            return lock

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, f"plan_{key}")

    def keys(self):
        if not os.path.isdir(self.root):
            return []
        return sorted(n[len("plan_"):] for n in os.listdir(self.root)
                      if n.startswith("plan_")
                      and manifest_exists(os.path.join(self.root, n)))

    # ------------------------------------------------------------------ #
    def _quarantine(self, path: str, reason: str) -> None:
        """Move a bad entry out of the live store into ``quarantine/``
        (suffixed ``.1``, ``.2``, ... when the same key lands there again),
        keeping the evidence and freeing the live slot."""
        qdir = os.path.join(self.root, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(qdir, f"{os.path.basename(path)}.{n}")
        try:
            os.replace(path, dest)
            with open(os.path.join(dest, "QUARANTINE_REASON.txt"),
                      "w") as fh:
                fh.write(reason + "\n")
        except OSError:
            # cross-device move or a racing writer: freeing the live slot
            # is the part that matters
            shutil.rmtree(path, ignore_errors=True)
        self.quarantined += 1
        if self.tracer.enabled:
            self.tracer.event("store.quarantine",
                              entry=os.path.basename(path), reason=reason)

    def _clean_partial(self, path: str) -> None:
        """Remove wreckage a crashed writer left behind: a ``.tmp`` staging
        dir, or a final dir with no manifest.  Either way the entry never
        became valid — a miss, not an error."""
        tmp = path + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        if os.path.isdir(path) and not manifest_exists(path):
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------------ #
    def put(self, engine: Engine, plan: ExecutionPlan) -> str:
        """Persist a compiled plan's schedule artifact (atomic)."""
        key = plan_cache_key(engine, plan.block_ffnn)
        extra = {
            "format": FORMAT_VERSION,
            "key": key,
            "n_layers": len(plan.layers),
            "io": plan.io.to_dict(),
            "compile_s": plan.compile_s,
            "annealer_iters": plan.annealer_iters,
            "fused": plan.fused,
        }
        return write_manifest_dir(self.path_for(key), plan.artifact_arrays(),
                                  extra, dtypes=_artifact_dtypes(plan))

    def load(self, engine: Engine, net: Net, backend: Optional[str] = None,
             verify: bool = True, mesh=None) -> Optional[ExecutionPlan]:
        """Rebuild a plan from a stored artifact, or None on miss.

        ``verify`` additionally checks that the flat-schedule arrays rebuilt
        from the stored order are bit-identical to the stored ones; a
        mismatch (an artifact written by incompatible packing code) is
        quarantined and treated as a miss.
        """
        key = plan_cache_key(engine, net, mesh)
        path = self.path_for(key)
        if not manifest_exists(path):
            # a crashed writer may have left a .tmp staging dir or a
            # manifest-less final dir: clean it, so the slot is a plain miss
            self._clean_partial(path)
            return None
        try:
            if self.injector is not None:
                self.injector.fire("store.load")
            arrays, extra = read_manifest_dir(path)
            if extra.get("format") != FORMAT_VERSION:
                # not corrupt — written by another store version; leave it
                return None
            io = IOReport.from_dict(extra["io"])
            order = arrays["order"]
        except (OSError, KeyError, ValueError, TypeError) as e:
            # corrupt/unreadable entry (crc mismatch, mangled manifest,
            # wrong-typed metadata field): quarantine it — a miss that
            # recompiles into a fresh entry, never a load loop
            self._quarantine(path, f"load raised {type(e).__name__}: {e}")
            return None
        plan = engine.compile_with_order(net, order, backend, io=io)
        if verify and not self._matches(plan, arrays):
            self._quarantine(path, "self-heal verify failed: rebuilt "
                                   "flat schedule != stored arrays")
            return None
        return plan

    @staticmethod
    def _matches(plan: ExecutionPlan, arrays: dict) -> bool:
        stored_fused = any(k.startswith("flat_") for k in arrays)
        if plan.fused != stored_fused:
            return False
        if plan.flat is None:
            return True
        rebuilt = plan.artifact_arrays()
        for name in ("rows", "cols", "first", "last", "layer_id",
                     "hbm_row", "out_tile", "bias_idx"):
            stored = arrays.get(f"flat_{name}")
            if stored is None or \
                    not np.array_equal(rebuilt[f"flat_{name}"], stored):
                return False
        if plan.flat.scales is not None:
            # quantized entries also verify the stored narrow blocks +
            # scales byte for byte against the deterministic requantization
            for name in ("flat_qblocks", "flat_scales"):
                stored, want = arrays.get(name), rebuilt[name]
                if (stored is None or stored.dtype != want.dtype
                        or stored.shape != want.shape
                        or stored.tobytes() != want.tobytes()):
                    return False
        return True

    def get_or_compile(self, engine: Engine, net: Net,
                       backend: Optional[str] = None,
                       mesh=None) -> Tuple[ExecutionPlan, bool]:
        """Warm-start compile: ``(plan, hit)``.

        Hit: rebuilt from the stored order, zero annealer iterations.
        Miss: full ``Engine.compile`` (schedule + CR), then persisted so the
        next process is warm.  Concurrent callers with the same key
        serialize on a per-key lock, so at most one of them pays the
        compile.
        """
        key = plan_cache_key(engine, net, mesh)
        with self._key_lock(key):
            with self.tracer.span("store.load", key=key[:12]) as sp:
                plan = self.load(engine, net, backend)
                sp["hit"] = plan is not None
            if plan is not None:
                return plan, True
            with self.tracer.span("store.compile", key=key[:12]):
                plan = engine.compile(net, backend)
                self.put(engine, plan)
            return plan, False
