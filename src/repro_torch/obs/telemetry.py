"""I/O-aware run-time telemetry: the paper's counters as live gauges.

At compile time a plan already knows its simulated tile I/O vs the
Theorem-1 bounds (`IOReport`) and — when gated — can measure the dynamic
block reads of a concrete batch (`DynamicIOReport`).  This module turns
those into *serving* telemetry:

  * :func:`plan_io_attrs` — a flat attribute dict for trace spans (works on
    both ``ExecutionPlan`` and ``ShardedExecutionPlan``);
  * :class:`IOTelemetry` — per-bucket aggregation of static plan gauges and
    per-batch measured dynamic I/O, owned by a ``SparseServer`` and exported
    through its snapshot and the Prometheus endpoint.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["plan_io_attrs", "IOTelemetry"]

#: occupancy-histogram bin labels, matching ``DynamicIOReport.per_layer_hist``
OCC_BINS = ("dead", "lt25", "lt50", "lt75", "le100")


def _weight_bytes(plan) -> int:
    # prefer the plan's own byte accounting: for a quantized weight stream
    # the schedule blocks are narrower than the f32 layer blocks, and the
    # IOReport counts exactly what the forward streams (blocks + scales)
    io = getattr(plan, "io", None)
    streamed = getattr(io, "weight_stream_bytes", 0)
    if streamed:
        return int(streamed)
    layers = getattr(plan, "layers", None)
    if not layers:
        return 0
    return int(sum(getattr(l.blocks, "nbytes", 0) for l in layers))


def _weight_bytes_by_dtype(plan) -> Dict[str, int]:
    """Streamed weight bytes split by storage dtype.

    Quantized plans stream narrow blocks plus one f32 scale per block, so
    the map has two entries (``{"bf16": ..., "f32": ...}``); an unquantized
    plan puts everything under ``"f32"``.  Empty when the plan predates
    byte accounting."""
    io = getattr(plan, "io", None)
    wdt = getattr(io, "weight_dtype", "f32")
    wbytes = int(getattr(io, "weight_bytes_streamed", 0) or 0)
    sbytes = int(getattr(io, "scale_bytes_streamed", 0) or 0)
    if not wbytes:
        return {}
    out = {wdt: wbytes}
    if sbytes:
        out["f32"] = out.get("f32", 0) + sbytes
    return out


def _nnz_blocks(plan) -> int:
    layers = getattr(plan, "layers", None)
    if not layers:
        return 0
    return int(sum(l.nnz_blocks for l in layers))


def plan_io_attrs(plan) -> Dict[str, object]:
    """Compact span attributes describing a plan's I/O profile.

    Handles both plan kinds: an ``ExecutionPlan`` (direct ``io`` field)
    and a ``ShardedExecutionPlan`` (``io`` property aggregating shards).
    Never raises — a plan missing a field simply omits the attribute.
    """
    attrs: Dict[str, object] = {}
    backend = getattr(plan, "backend", None)
    if backend is not None:
        attrs["backend"] = backend
    for name in ("fused", "gate"):
        v = getattr(plan, name, None)
        if v is not None:
            attrs[name] = bool(v)
    shards = getattr(plan, "shards", None)
    if shards is not None:
        attrs["shards"] = len(shards)
    io = getattr(plan, "io", None)
    if io is None:
        return attrs
    sim = getattr(io, "simulated", None)
    if sim is not None:
        attrs["io_tile_reads"] = int(sim.reads)
        attrs["io_tile_writes"] = int(sim.writes)
        attrs["io_tile_total"] = int(sim.total)
        attrs["io_optimality_ratio"] = round(float(io.optimality_ratio), 4)
        attrs["io_within_bounds"] = bool(io.within_bounds)
    streamed = getattr(io, "weight_stream_bytes", 0)
    if streamed:
        attrs["io_weight_bytes"] = int(streamed)
        attrs["weight_dtype"] = getattr(io, "weight_dtype", "f32")
    dyn = getattr(io, "dynamic", None)
    if dyn is not None:
        attrs["io_dynamic_blocks"] = int(dyn.dynamic_total)
        attrs["io_static_blocks"] = int(dyn.static_total)
        attrs["io_read_fraction"] = round(float(dyn.read_fraction), 4)
    nnz = _nnz_blocks(plan)
    if nnz:
        attrs["nnz_blocks"] = nnz
    return attrs


class _BucketIO:
    """Per-bucket aggregate: static plan gauges (set once) + running
    dynamic measurements."""

    __slots__ = ("bucket", "static_blocks", "weight_bytes", "tile_reads",
                 "tile_writes", "optimality_ratio", "within_bounds",
                 "bytes_per_block", "batches_measured", "dynamic_blocks",
                 "static_scheduled", "dynamic_bytes", "last_read_fraction",
                 "occupancy_hist", "weight_dtype", "weight_bytes_by_dtype")

    def __init__(self, bucket: int):
        self.bucket = bucket
        # static (schedule) gauges — properties of the compiled plan
        self.static_blocks = 0          # nonzero weight blocks in the net
        self.weight_bytes = 0           # bytes of weight blocks on disk/HBM
        self.weight_dtype = "f32"       # storage dtype of streamed blocks
        self.weight_bytes_by_dtype: Dict[str, int] = {}
        self.tile_reads = 0             # simulated tile reads (paper model)
        self.tile_writes = 0
        self.optimality_ratio = 0.0     # simulated / Theorem-1 lower bound
        self.within_bounds = True
        self.bytes_per_block = 0.0
        # dynamic (measured) aggregates — properties of actual batches
        self.batches_measured = 0
        self.dynamic_blocks = 0         # sum of measured dynamic reads
        self.static_scheduled = 0       # sum of static schedule lengths
        self.dynamic_bytes = 0          # estimated weight bytes streamed
        self.last_read_fraction = 1.0
        self.occupancy_hist = [0] * len(OCC_BINS)

    def to_dict(self) -> dict:
        d = {
            "bucket": self.bucket,
            "static_blocks": self.static_blocks,
            "weight_bytes": self.weight_bytes,
            "tile_reads": self.tile_reads,
            "tile_writes": self.tile_writes,
            "optimality_ratio": round(self.optimality_ratio, 4),
            "within_bounds": self.within_bounds,
        }
        if self.weight_bytes_by_dtype:
            d["weight_dtype"] = self.weight_dtype
            d["weight_bytes_by_dtype"] = dict(self.weight_bytes_by_dtype)
        if self.batches_measured:
            d.update({
                "batches_measured": self.batches_measured,
                "dynamic_blocks": self.dynamic_blocks,
                "static_scheduled": self.static_scheduled,
                "dynamic_bytes": self.dynamic_bytes,
                "read_fraction": round(
                    self.dynamic_blocks / max(1, self.static_scheduled), 4),
                "last_read_fraction": round(self.last_read_fraction, 4),
                "occupancy_hist": dict(zip(OCC_BINS, self.occupancy_hist)),
            })
        return d


class IOTelemetry:
    """Thread-safe per-bucket I/O gauge aggregation for one served model.

    ``observe_plan`` records a bucket's static gauges from its compiled
    plan (idempotent — re-observing after a hot-swap refreshes them);
    ``observe_dynamic`` folds in one batch's measured ``DynamicIOReport``.
    The lock is a leaf: nothing is called while holding it.
    """

    def __init__(self, model: str = "default"):
        self.model = model
        self._mu = threading.Lock()
        self._buckets: Dict[int, _BucketIO] = {}

    def _get(self, bucket: int) -> _BucketIO:
        b = self._buckets.get(bucket)
        if b is None:
            b = self._buckets[bucket] = _BucketIO(bucket)
        return b

    def observe_plan(self, bucket: int, plan) -> None:
        """Record the static I/O gauges of the plan serving ``bucket``."""
        nnz = _nnz_blocks(plan)
        wbytes = _weight_bytes(plan)
        by_dtype = _weight_bytes_by_dtype(plan)
        io = getattr(plan, "io", None)
        wdt = getattr(io, "weight_dtype", "f32")
        sim = getattr(io, "simulated", None)
        with self._mu:
            b = self._get(bucket)
            b.static_blocks = nnz
            b.weight_bytes = wbytes
            b.weight_dtype = wdt
            b.weight_bytes_by_dtype = by_dtype
            b.bytes_per_block = wbytes / nnz if nnz else 0.0
            if sim is not None:
                b.tile_reads = int(sim.reads)
                b.tile_writes = int(sim.writes)
                b.optimality_ratio = float(io.optimality_ratio)
                b.within_bounds = bool(io.within_bounds)

    def observe_dynamic(self, bucket: int, report) -> None:
        """Fold one batch's measured ``DynamicIOReport`` into ``bucket``."""
        dyn = int(report.dynamic_total)
        stat = int(report.static_total)
        with self._mu:
            b = self._get(bucket)
            b.batches_measured += 1
            b.dynamic_blocks += dyn
            b.static_scheduled += stat
            b.dynamic_bytes += int(dyn * b.bytes_per_block)
            b.last_read_fraction = float(report.read_fraction)
            for hist in report.per_layer_hist:
                for i, n in enumerate(hist[:len(OCC_BINS)]):
                    b.occupancy_hist[i] += int(n)

    def snapshot(self) -> dict:
        """Per-bucket gauges plus model-level totals (JSON-safe)."""
        with self._mu:
            buckets = {b.bucket: b.to_dict()
                       for b in self._buckets.values()}
        measured = [b for b in buckets.values() if "dynamic_blocks" in b]
        total_dyn = sum(b["dynamic_blocks"] for b in measured)
        total_stat = sum(b["static_scheduled"] for b in measured)
        out = {
            "model": self.model,
            "buckets": buckets,
            "batches_measured": sum(b.get("batches_measured", 0)
                                    for b in buckets.values()),
        }
        if measured:
            out["dynamic_blocks"] = total_dyn
            out["static_scheduled"] = total_stat
            out["read_fraction"] = round(total_dyn / max(1, total_stat), 4)
            out["dynamic_bytes"] = sum(b["dynamic_bytes"] for b in measured)
        return out
