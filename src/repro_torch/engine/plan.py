"""Execution plans: the compile-once/run-many artifact of ``Engine.compile``.

Port of ``repro.engine.plan``.  A plan owns everything derived offline from a
``BlockFFNN``: the whole-network connection order, its per-layer kernel
schedules (and the flat cross-layer schedule when fused), the epilogues, a
forward for the chosen backend, and an :class:`IOReport` — the exact
simulated tile traffic of the order next to the Theorem-1 bounds.  The
reports serialize to the same dicts as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.blocksparse import BlockFFNN, BSRLayer
from ..core.bounds import Bounds
from ..core.iosim import IOStats
from ..kernels.ops import CompiledSchedule, FlatSchedule


@dataclasses.dataclass(frozen=True)
class DynamicIOReport:
    """Measured dynamic I/O of one gated forward on one concrete batch.

    ``per_layer_dynamic[k]`` counts the scheduled layer-``k`` blocks whose
    input tile was live for some real batch row, next to the full
    ``per_layer_static[k]`` schedule length; the occupancy fields say why:
    ``per_layer_live_tiles[k]`` of ``per_layer_in_tiles[k]`` input tiles
    were live, ``per_layer_row_occupancy[k]`` is the mean live-row fraction
    per tile, and ``per_layer_hist[k]`` buckets tiles by live-row fraction
    as ``(dead, (0,.25), [.25,.5), [.5,.75), [.75,1])``.
    ``ExecutionPlan.measure_dynamic`` produces it; ``bytes_per_block`` turns
    block counts into the weight bytes a demand-driven stream reads.
    """

    batch: int
    per_layer_static: Tuple[int, ...]
    per_layer_dynamic: Tuple[int, ...]
    per_layer_in_tiles: Tuple[int, ...]
    per_layer_live_tiles: Tuple[int, ...]
    per_layer_row_occupancy: Tuple[float, ...]
    per_layer_hist: Tuple[Tuple[int, int, int, int, int], ...]
    bytes_per_block: int = 0
    weight_dtype: str = "f32"

    @property
    def static_total(self) -> int:
        return sum(self.per_layer_static)

    @property
    def dynamic_total(self) -> int:
        return sum(self.per_layer_dynamic)

    @property
    def blocks_skipped(self) -> int:
        return self.static_total - self.dynamic_total

    @property
    def dynamic_weight_bytes(self) -> int:
        return self.dynamic_total * self.bytes_per_block

    @property
    def static_weight_bytes(self) -> int:
        return self.static_total * self.bytes_per_block

    @property
    def read_fraction(self) -> float:
        return self.dynamic_total / max(1, self.static_total)

    def summary(self) -> str:
        occ = "/".join(f"{f:.2f}" for f in self.per_layer_row_occupancy)
        return (f"dynamic I/O at B={self.batch}: read "
                f"{self.dynamic_total}/{self.static_total} scheduled weight "
                f"blocks ({100 * self.read_fraction:.0f}%, "
                f"{self.blocks_skipped} skipped); per-layer row occupancy "
                f"[{occ}]")

    def to_dict(self) -> dict:
        return {
            "batch": int(self.batch),
            "per_layer_static": [int(v) for v in self.per_layer_static],
            "per_layer_dynamic": [int(v) for v in self.per_layer_dynamic],
            "per_layer_in_tiles": [int(v) for v in self.per_layer_in_tiles],
            "per_layer_live_tiles": [int(v)
                                     for v in self.per_layer_live_tiles],
            "per_layer_row_occupancy": [float(v) for v in
                                        self.per_layer_row_occupancy],
            "per_layer_hist": [[int(v) for v in h]
                               for h in self.per_layer_hist],
            "bytes_per_block": int(self.bytes_per_block),
            "weight_dtype": self.weight_dtype,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DynamicIOReport":
        return cls(
            batch=d["batch"],
            per_layer_static=tuple(d["per_layer_static"]),
            per_layer_dynamic=tuple(d["per_layer_dynamic"]),
            per_layer_in_tiles=tuple(d["per_layer_in_tiles"]),
            per_layer_live_tiles=tuple(d["per_layer_live_tiles"]),
            per_layer_row_occupancy=tuple(d["per_layer_row_occupancy"]),
            per_layer_hist=tuple(tuple(h) for h in d["per_layer_hist"]),
            bytes_per_block=int(d.get("bytes_per_block", 0)),
            weight_dtype=d.get("weight_dtype", "f32"),
        )


@dataclasses.dataclass(frozen=True)
class IOReport:
    """Predicted I/O of a compiled plan vs. the paper's Theorem-1 window.

    ``simulated`` is the exact tile traffic of the plan's connection order
    under the single-resident-tile model (``core.iosim.simulate`` on the
    block DAG); ``bounds`` are Theorem 1's bounds for the same DAG.  The
    cross-layer fields count what fusing saves over per-layer dispatch:
    ``hidden_tiles_kept`` intermediate tiles (and
    ``hidden_bytes_kept_per_row`` bytes per batch row) that the fused plan
    never writes out between layers.  On the H100 "kept" means kept out of
    the HBM round trip of a per-layer launch: the megakernel holds them in
    a global ping-pong buffer that stays in the L2 cache, since they do not
    fit a CTA's shared memory.  The byte fields restate the weight stream in
    the storage dtype.  The counts do not depend on the device, so the
    report equals the reference's for the same net and settings.
    """

    simulated: IOStats
    bounds: Bounds
    M_tiles: int
    policy: str
    layered_reads: int = 0
    layered_writes: int = 0
    hidden_tiles_kept: int = 0
    hidden_bytes_kept_per_row: int = 0
    weight_dtype: str = "f32"
    weight_bytes_streamed: int = 0
    scale_bytes_streamed: int = 0
    activation_bytes_per_row: int = 0
    dynamic: Optional[DynamicIOReport] = None

    @property
    def within_total_bound(self) -> bool:
        return self.simulated.total <= self.bounds.total_hi

    @property
    def within_write_bounds(self) -> bool:
        return (self.bounds.writes_lo <= self.simulated.writes
                <= self.bounds.writes_hi)

    @property
    def within_bounds(self) -> bool:
        return self.within_total_bound and self.within_write_bounds

    @property
    def optimality_ratio(self) -> float:
        """simulated / lower bound (1.0 for an empty DAG)."""
        if self.simulated.total == 0 and self.bounds.total_lo == 0:
            return 1.0
        return self.simulated.total / max(1, self.bounds.total_lo)

    @property
    def weight_stream_bytes(self) -> int:
        """Total weight-stream bytes per forward: narrow blocks + scales."""
        return self.weight_bytes_streamed + self.scale_bytes_streamed

    @property
    def layered_total(self) -> int:
        return self.layered_reads + self.layered_writes

    @property
    def cross_layer_savings(self) -> int:
        return max(0, self.layered_total - self.simulated.total)

    def summary(self) -> str:
        s, b = self.simulated, self.bounds
        msg = (f"tile I/O {s.total} (r={s.reads} w={s.writes}) in "
               f"[{b.total_lo}, {b.total_hi}] "
               f"(x{self.optimality_ratio:.2f} of lower bound, "
               f"M={self.M_tiles} tiles, {self.policy.upper()})")
        if self.weight_bytes_streamed:
            msg += (f"; weight stream {self.weight_stream_bytes} B "
                    f"as {self.weight_dtype}")
        if self.layered_total:
            msg += (f"; fused saves {self.cross_layer_savings} tile I/Os vs "
                    f"layered ({self.hidden_tiles_kept} hidden tiles / "
                    f"{self.hidden_bytes_kept_per_row} B/row kept on chip)")
        if self.dynamic is not None:
            msg += "; " + self.dynamic.summary()
        return msg

    def to_dict(self) -> dict:
        """JSON-serializable form, identical to the reference's."""
        return {
            "simulated": {"reads": int(self.simulated.reads),
                          "writes": int(self.simulated.writes)},
            "bounds": {
                "reads_lo": int(self.bounds.reads_lo),
                "reads_hi": int(self.bounds.reads_hi),
                "writes_lo": int(self.bounds.writes_lo),
                "writes_hi": int(self.bounds.writes_hi),
            },
            "M_tiles": int(self.M_tiles),
            "policy": self.policy,
            "layered_reads": int(self.layered_reads),
            "layered_writes": int(self.layered_writes),
            "hidden_tiles_kept": int(self.hidden_tiles_kept),
            "hidden_bytes_kept_per_row": int(self.hidden_bytes_kept_per_row),
            "weight_dtype": self.weight_dtype,
            "weight_bytes_streamed": int(self.weight_bytes_streamed),
            "scale_bytes_streamed": int(self.scale_bytes_streamed),
            "activation_bytes_per_row": int(self.activation_bytes_per_row),
            "dynamic": None if self.dynamic is None
            else self.dynamic.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "IOReport":
        dyn = d.get("dynamic")
        return cls(
            simulated=IOStats(**d["simulated"]),
            bounds=Bounds(**d["bounds"]),
            M_tiles=d["M_tiles"],
            policy=d["policy"],
            layered_reads=d.get("layered_reads", 0),
            layered_writes=d.get("layered_writes", 0),
            hidden_tiles_kept=d.get("hidden_tiles_kept", 0),
            hidden_bytes_kept_per_row=d.get("hidden_bytes_kept_per_row", 0),
            weight_dtype=d.get("weight_dtype", "f32"),
            weight_bytes_streamed=d.get("weight_bytes_streamed", 0),
            scale_bytes_streamed=d.get("scale_bytes_streamed", 0),
            activation_bytes_per_row=d.get("activation_bytes_per_row", 0),
            dynamic=None if dyn is None else DynamicIOReport.from_dict(dyn),
        )


def _raw(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy; narrow float dtypes (which numpy lacks) as their raw
    bits in an unsigned integer of the same width."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


@dataclasses.dataclass
class ExecutionPlan:
    """A compiled whole-network inference plan.  Call it on inputs."""

    layers: List[BSRLayer]
    schedules: List[CompiledSchedule]
    activations: List[object]               # epilogue name or callable per layer
    backend: str                            # resolved backend name
    order: np.ndarray                       # block-DAG connection order
    block_ffnn: BlockFFNN
    io: IOReport
    device: torch.device
    flat: Optional[FlatSchedule] = None     # cross-layer schedule (fused)
    _forward: Callable = dataclasses.field(repr=False, default=None)
    calls: int = dataclasses.field(default=0, compare=False)
    compile_s: float = 0.0                  # wall time of Engine._build
    annealer_iters: int = 0                 # CR proposals paid for this plan
    gate: bool = False                      # runtime tile-occupancy gating
    # why the plan is not (fully) what was asked for; describe() shows it
    fallback_reason: Optional[str] = None
    # the gated fused plan's instrumented twin: x -> (y, occupancies)
    _measure: Optional[Callable] = dataclasses.field(repr=False,
                                                     default=None)

    @property
    def fused(self) -> bool:
        """True when the plan executes as one flat cross-layer dispatch."""
        return self.flat is not None

    @property
    def n_in(self) -> int:
        return self.layers[0].n_in

    @property
    def n_out(self) -> int:
        return self.layers[-1].n_out

    @property
    def dtype(self) -> torch.dtype:
        """The plan's input dtype (serving callers cast to it first).
        Independent of ``weight_dtype`` — activations stay f32."""
        return torch.from_numpy(
            np.empty(0, dtype=self.layers[0].blocks.dtype)).dtype

    @property
    def weight_dtype(self) -> str:
        """Storage dtype of the streamed weight blocks (f32/bf16/fp8)."""
        return self.schedules[0].weight_dtype if self.schedules else "f32"

    def __call__(self, x) -> torch.Tensor:
        """Run inference.  ``x`` is ``[n_in]`` or batched ``[B, n_in]`` (a
        tensor or array); the result is a tensor on the plan's device."""
        x, single = self._input(x)
        y = self._forward(x)
        self.calls += 1
        return y[0] if single else y

    def _input(self, x) -> Tuple[torch.Tensor, bool]:
        """``x`` as a contiguous [B, n_in] tensor on the plan's device, and
        whether it came as one row."""
        x = torch.as_tensor(x, device=self.device)
        single = x.ndim == 1
        if single:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.n_in:
            raise ValueError(
                f"expected input [B, {self.n_in}] or [{self.n_in}], "
                f"got {tuple(x.shape)}"
            )
        return x.contiguous(), single

    def with_fresh_forward(self) -> "ExecutionPlan":
        """A copy of this plan with a newly lowered forward (call count 0);
        the schedule substrate is shared by reference, and a gated fused
        plan gets a fresh measurement twin too."""
        from .backends import (
            make_forward,
            make_fused_forward,
            make_fused_measure,
        )

        measure = None
        if self.flat is not None:
            fwd = make_fused_forward(self.layers, self.flat, self.activations,
                                     self.backend, gate=self.gate)
            if self.gate:
                measure = make_fused_measure(self.layers, self.flat,
                                             self.activations, self.backend)
        else:
            fwd = make_forward(self.layers, self.schedules, self.activations,
                               self.backend, gate=self.gate)
        return dataclasses.replace(self, _forward=fwd, _measure=measure,
                                   calls=0)

    def safe_twin(self) -> "ExecutionPlan":
        """The plan's safe-mode twin: same schedule tensors and backend,
        lowered per layer with the gate off — on the ``kernel`` backend one
        ungated ``bsr_matmul`` launch per layer (what ``--no-fuse`` runs),
        the simplest hand-written kernel route.  A circuit breaker degrades
        to it; it never turns a ``kernel`` plan into plain PyTorch (the
        reference's twin is its plain ``jnp`` path: ``ROADMAP.md`` §3)."""
        twin = dataclasses.replace(self, flat=None, gate=False)
        return twin.with_fresh_forward()

    def plain(self) -> "ExecutionPlan":
        """The plan's plain PyTorch version: same schedule, ``torch``
        backend, gate off — the ground truth that kernel answers are held
        against (the ungated forward equals the gated one)."""
        return dataclasses.replace(self, backend="torch",
                                   gate=False).with_fresh_forward()

    def measure_dynamic(self, x) -> DynamicIOReport:
        """Run one instrumented gated forward on ``x`` and report measured
        dynamic I/O: scheduled weight blocks actually consumed per layer vs
        the static Theorem-1 schedule, plus per-layer occupancy histograms.
        The report is also recorded on ``self.io.dynamic``.
        """
        if self._measure is None:
            raise RuntimeError(
                "dynamic I/O measurement needs a gated fused plan — compile "
                "with Engine(gate=True) on a net the flat schedule can "
                "express (uniform square tiles)"
            )
        x, _ = self._input(x)
        _, occs = self._measure(x)
        B = int(x.shape[0])
        bs = self.flat.block
        bpb = bs * bs * self.flat.blocks.element_size()
        if self.flat.scales is not None:
            bpb += 4                     # the per-block f32 dequant scale
        rows = self.flat.rows.cpu().numpy()
        stat, dyn, in_tiles, live, row_occ, hists = [], [], [], [], [], []
        for k, (s, e) in enumerate(self.flat.segments):
            occ = occs[k].cpu().numpy()
            stat.append(int(e - s))
            dyn.append(int(np.sum(occ[rows[s:e]] > 0)))
            in_tiles.append(int(occ.size))
            live.append(int(np.sum(occ > 0)))
            frac = occ.astype(np.float64) / max(1, B)
            row_occ.append(float(frac.mean()) if frac.size else 0.0)
            alive = frac[occ > 0]
            hist = np.histogram(alive, bins=[0.0, 0.25, 0.5, 0.75,
                                             1.0 + 1e-9])[0]
            hists.append((int(np.sum(occ == 0)),)
                         + tuple(int(n) for n in hist))
        report = DynamicIOReport(
            batch=B,
            per_layer_static=tuple(stat),
            per_layer_dynamic=tuple(dyn),
            per_layer_in_tiles=tuple(in_tiles),
            per_layer_live_tiles=tuple(live),
            per_layer_row_occupancy=tuple(row_occ),
            per_layer_hist=tuple(hists),
            bytes_per_block=int(bpb),
            weight_dtype=self.flat.weight_dtype,
        )
        self.io = dataclasses.replace(self.io, dynamic=report)
        return report

    def trace_attrs(self) -> dict:
        """Flat span-attribute dict of this plan's I/O profile (backend,
        fusion/gating, simulated tile I/O vs the Theorem-1 lower bound, the
        latest measured dynamic reads): ``obs.telemetry.plan_io_attrs``."""
        from ..obs.telemetry import plan_io_attrs
        return plan_io_attrs(self)

    def describe(self) -> str:
        shapes = " -> ".join(
            [str(self.n_in)] + [str(l.n_out) for l in self.layers])
        nnz = sum(l.nnz_blocks for l in self.layers)
        mode = "fused" if self.fused else "layered"
        if self.gate:
            mode += "+gated"
        if self.weight_dtype != "f32":
            mode += f"+{self.weight_dtype}"
        fallback = "" if self.fallback_reason is None \
            else f" [fallback: {self.fallback_reason}]"
        return (f"ExecutionPlan[{self.backend}/{mode} on {self.device}]"
                f"{fallback} {shapes} "
                f"({len(self.layers)} layers, {nnz} nonzero blocks); "
                + self.io.summary()
                + f"; compiled in {self.compile_s:.2f}s "
                  f"({self.annealer_iters} annealer iters), "
                  f"{self.calls} calls")

    def artifact_arrays(self) -> dict:
        """The plan's persistable schedule arrays, as host numpy — the same
        keys and values as the reference's.  Narrow quantized blocks
        (``flat_qblocks``) come as their raw bits (uint16 for bf16, uint8
        for fp8), since numpy has no such float types."""
        out = {"order": np.asarray(self.order, dtype=np.int64)}
        if self.flat is not None:
            f = self.flat
            for name in ("rows", "cols", "first", "last", "layer_id",
                         "hbm_row", "out_tile", "bias_idx"):
                out[f"flat_{name}"] = _raw(getattr(f, name)).astype(np.int32)
            if f.scales is not None:
                out["flat_qblocks"] = _raw(f.blocks)
                out["flat_scales"] = _raw(f.scales).astype(np.float32)
        return out
