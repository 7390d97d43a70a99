"""Sharded execution plans: the block DAG partitioned over a device mesh.

Port of ``repro.engine.sharding``.  The paper's I/O model is per device, so
a network scales past one device as one independent Theorem-1 schedule per
shard:

    from repro_torch.engine import Engine, Mesh

    plan = Engine().compile(layers, mesh=Mesh(model=4, data=2))
    y = plan(x)
    print(plan.io_report().summary())   # per-shard traffic + imbalance

``Mesh(model, data)`` partitions every layer's output tiles over ``model``
(equal counts, balanced by nonzero blocks: ``core.graph.
partition_columns_balanced``) and the batch over ``data``.  Each model shard
gets its own shard DAG, an ordinary paper FFNN, so the single-device builder
(``Engine._build``: Theorem-1 order, Connection Reordering, packing, I/O
simulation) runs on it unchanged.  Partitions, orders, schedule arrays and
reports equal the reference's.

Lowering.  On one device the forward is a sequential loop over the shards:
per layer, each shard computes its owned output tiles from the full
activation and writes them into their places of one output buffer.  On the
``kernel`` backend a shard's layer is one ``bsr_matmul`` launch on that
shard's own compiled schedule, so a forward makes ``model x layers``
launches; on ``torch`` it is the plain segment lowering.  (The reference
runs its shard layers as plain ``jnp`` whatever the backend.)  The
collective lowering — one process per mesh slot, ``torch.distributed``
all-gathers over the model axis, the batch split over the data axis — is
reached through :meth:`ShardedExecutionPlan.with_process_group`; the
reference picks ``shard_map`` by itself when the host has a device per mesh
slot, which one PyTorch process cannot do across processes.  A one-shard
``model`` axis builds none of this: its forward is the unsharded plan's own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.blocksparse import BlockFFNN, BSRLayer
from ..core.graph import FFNN, partition_columns_balanced
from .backends import ShardedSegment, make_sharded_forward
from .plan import ExecutionPlan, IOReport


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's slot in a (data, model) grid of processes, and the
    subgroups its collectives run over: ``model_group`` holds the model
    shards of this data replica, ``data_group`` the data replicas of this
    model shard."""

    model_index: int
    data_index: int
    model_group: object
    data_group: object


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Logical device mesh for a sharded plan: tile-parallel ``model`` axis
    x batch-parallel ``data`` axis.

    A spec, not a device object: compiling against ``Mesh(4, 2)`` on one
    card is legal — the plan runs the sequential shard loop and computes the
    same function.
    """

    model: int = 1
    data: int = 1

    def __post_init__(self):
        if self.model < 1 or self.data < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self}")

    @property
    def size(self) -> int:
        return self.model * self.data

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.model, self.data)

    @classmethod
    def parse(cls, spec: str) -> "Mesh":
        """Parse a CLI mesh spec: ``"4x2"`` = 4 model shards x 2 data
        replicas; ``"4"`` means ``4x1``."""
        model, _, data = spec.strip().lower().partition("x")
        try:
            return cls(model=int(model), data=int(data) if data else 1)
        except ValueError:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected MODELxDATA, e.g. 4x2"
            ) from None

    def process_mesh(self, group=None) -> Optional[ProcessMesh]:
        """The counterpart of the reference's ``jax_mesh()``: None (use the
        sequential loop) for a single-slot mesh or without a process group;
        otherwise this process's slot in ``group``, whose ranks are laid out
        ``(data, model)`` as the reference's mesh.  Collective: every
        process of the default group calls it, in the same order (it
        creates the axis subgroups)."""
        if group is None or self.size <= 1:
            return None
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(group)
        if len(ranks) != self.size:
            raise ValueError(f"a {self.model}x{self.data} mesh needs a "
                             f"process group of {self.size}, got "
                             f"{len(ranks)}")
        rank = ranks.index(dist.get_rank())
        grid = np.asarray(ranks).reshape(self.data, self.model)
        model_groups = [dist.new_group(row.tolist()) for row in grid]
        data_groups = [dist.new_group(col.tolist()) for col in grid.T]
        d, m = divmod(rank, self.model)
        return ProcessMesh(model_index=m, data_index=d,
                           model_group=model_groups[d],
                           data_group=data_groups[m])


@dataclasses.dataclass
class ShardSpec:
    """One model shard's view of the network.

    ``layers[k]`` keeps the full layer-``k`` input width (the shard reads
    the gathered activation) but only the owned output tiles, re-indexed to
    local column ids.  ``owned[k][p]`` is the global output tile behind
    local tile ``p``.  ``bffnn`` is the shard DAG.
    """

    bffnn: BlockFFNN
    owned: List[np.ndarray]


def partition_model(bffnn: BlockFFNN, model: int) -> List[ShardSpec]:
    """Partition the block-column DAG into ``model`` balanced shards.

    Every layer's output tiles are split into equal-count groups balancing
    per-shard nonzero-block load; raises ``ValueError`` when a layer's tile
    grid is not divisible by ``model``.  ``model=1`` returns the whole
    network as the single shard.
    """
    layers = bffnn.layers
    if model == 1:
        return [ShardSpec(bffnn=bffnn,
                          owned=[np.arange(l.grid_out) for l in layers])]

    offsets = [0, layers[0].grid_in]
    for lay in layers:
        offsets.append(offsets[-1] + lay.grid_out)
    n_tiles = offsets[-1]

    assigns = []
    for k, lay in enumerate(layers):
        if lay.grid_out % model:
            raise ValueError(
                f"layer {k} has {lay.grid_out} output tiles, not divisible "
                f"by the model axis ({model}); pick a mesh whose model size "
                "divides every layer's tile grid"
            )
        loads = np.bincount(lay.cols, minlength=lay.grid_out)
        assigns.append(partition_columns_balanced(loads, model))

    shards = []
    for s in range(model):
        owned_s: List[np.ndarray] = []
        shard_layers: List[BSRLayer] = []
        src_l, dst_l, lay_l, blk_l = [], [], [], []
        owned_mask = np.zeros(n_tiles, dtype=bool)
        for k, lay in enumerate(layers):
            owned = np.flatnonzero(assigns[k] == s)
            owned_s.append(owned)
            owned_mask[offsets[k + 1] + owned] = True
            local = np.full(lay.grid_out, -1, dtype=np.int64)
            local[owned] = np.arange(len(owned))
            sel = np.flatnonzero(local[lay.cols] >= 0)
            bias = np.ascontiguousarray(
                lay.bias.reshape(lay.grid_out, lay.block_n)[owned]
            ).reshape(-1)
            shard_layers.append(BSRLayer(
                n_in=lay.n_in,
                n_out=len(owned) * lay.block_n,
                block_m=lay.block_m,
                block_n=lay.block_n,
                rows=lay.rows[sel].astype(np.int32),
                cols=local[lay.cols[sel]].astype(np.int32),
                blocks=lay.blocks[sel],
                bias=bias.astype(np.float32),
            ))
            src_l.append(lay.rows[sel].astype(np.int64) + offsets[k])
            dst_l.append(lay.cols[sel].astype(np.int64) + offsets[k + 1])
            lay_l.append(np.full(len(sel), k, dtype=np.int32))
            blk_l.append(np.arange(len(sel), dtype=np.int64))
        src = np.concatenate(src_l)
        dst = np.concatenate(dst_l)
        # outputs = owned tiles this shard actually produces; owned tiles
        # with no incoming block are bias-patched dead code, dropped from
        # the I/O analysis as the unsharded path drops them
        produced = np.zeros(n_tiles, dtype=bool)
        produced[dst] = True
        net = FFNN(
            n_neurons=n_tiles, src=src, dst=dst,
            weight=np.ones(len(src), dtype=np.float32),
            is_input=~owned_mask,     # inputs + tiles arriving by all-gather
            is_output=owned_mask & produced,
            bias=np.zeros(n_tiles, dtype=np.float32),
        )
        shards.append(ShardSpec(
            bffnn=BlockFFNN(layers=shard_layers, net=net,
                            conn_layer=np.concatenate(lay_l),
                            conn_block=np.concatenate(blk_l)),
            owned=owned_s,
        ))
    return shards


# --------------------------------------------------------------------------- #
# aggregate I/O report
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ShardedIOReport:
    """Per-shard Theorem-1 I/O reports + the cross-shard aggregates.

    Each entry of ``per_shard`` is that shard's simulated tile traffic next
    to its own shard DAG's Theorem-1 bounds.  The aggregate is the sum;
    ``load_imbalance`` = max shard traffic / mean shard traffic (1.0 =
    balanced).  ``data`` replicas stream the same tiles for other batch
    rows, so per-shard counts are per data replica.  Serializes to the
    reference's dict.
    """

    per_shard: Tuple[IOReport, ...]
    model: int = 1
    data: int = 1

    @property
    def reads(self) -> int:
        return sum(r.simulated.reads for r in self.per_shard)

    @property
    def writes(self) -> int:
        return sum(r.simulated.writes for r in self.per_shard)

    @property
    def total(self) -> int:
        return self.reads + self.writes

    @property
    def within_bounds(self) -> bool:
        return all(r.within_bounds for r in self.per_shard)

    @property
    def load_imbalance(self) -> float:
        totals = [r.simulated.total for r in self.per_shard]
        mean = sum(totals) / max(1, len(totals))
        if mean == 0:
            return 1.0
        return max(totals) / mean

    @property
    def max_shard_total(self) -> int:
        return max(r.simulated.total for r in self.per_shard)

    @property
    def weight_dtype(self) -> str:
        return self.per_shard[0].weight_dtype if self.per_shard else "f32"

    @property
    def weight_bytes_streamed(self) -> int:
        return sum(r.weight_bytes_streamed for r in self.per_shard)

    @property
    def scale_bytes_streamed(self) -> int:
        return sum(r.scale_bytes_streamed for r in self.per_shard)

    @property
    def weight_stream_bytes(self) -> int:
        """Aggregate weight-stream bytes (blocks + scales) per data replica."""
        return sum(r.weight_stream_bytes for r in self.per_shard)

    def summary(self) -> str:
        return (f"sharded tile I/O {self.total} over {self.model} model "
                f"shard(s) x {self.data} data (max shard "
                f"{self.max_shard_total}, imbalance "
                f"x{self.load_imbalance:.2f}, "
                f"{'within' if self.within_bounds else 'OUTSIDE'} per-shard "
                "Theorem-1 bounds)")

    def to_dict(self) -> dict:
        return {"model": self.model, "data": self.data,
                "per_shard": [r.to_dict() for r in self.per_shard]}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardedIOReport":
        return cls(per_shard=tuple(IOReport.from_dict(r)
                                   for r in d["per_shard"]),
                   model=d["model"], data=d["data"])


# --------------------------------------------------------------------------- #
# the sharded plan
# --------------------------------------------------------------------------- #

def _shard_not_runnable(*_a, **_k):
    raise RuntimeError(
        "a model-parallel shard plan is not standalone-runnable — its "
        "layers read the all-gathered activation; call the "
        "ShardedExecutionPlan instead"
    )


# the layered path's own words (engine.Engine._build), kept for parity
_GATE_INACTIVE = "occupancy gating inactive on the layered pallas path"


@dataclasses.dataclass
class ShardedExecutionPlan:
    """A compiled plan partitioned over a ``Mesh``.  Call it on inputs.

    ``shards[s]`` is an :class:`ExecutionPlan` built by ``Engine._build`` on
    shard ``s``'s DAG: its ``order``, ``schedules``, ``flat`` arrays and
    ``io`` report are the per-shard artifacts the plan store persists.  With
    ``model > 1`` the shard plans are not runnable on their own; the
    forward walks their per-layer schedules (``segments``).  ``layered``
    marks the safe twin of a one-shard plan (per-layer dispatch, as
    ``ExecutionPlan.safe_twin``); ``process_mesh`` the collective lowering.
    """

    mesh: Mesh
    shards: List[ExecutionPlan]
    owned: List[List[np.ndarray]]   # [shard][layer] global output-tile ids
    backend: str
    gate: bool = False              # runtime tile-occupancy gating
    block_ffnn: BlockFFNN = None    # the unpartitioned network
    segments: List[ShardedSegment] = dataclasses.field(default_factory=list,
                                                       repr=False)
    layered: bool = False
    process_mesh: Optional[ProcessMesh] = None
    _forward: Callable = dataclasses.field(repr=False, default=None)
    calls: int = dataclasses.field(default=0, compare=False)
    compile_s: float = 0.0

    @property
    def n_in(self) -> int:
        return self.shards[0].n_in

    @property
    def n_out(self) -> int:
        return sum(s.layers[-1].n_out for s in self.shards)

    @property
    def n_layers(self) -> int:
        return len(self.shards[0].layers)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def dtype(self) -> torch.dtype:
        """The plan's input dtype (serving callers cast to it first)."""
        return self.shards[0].dtype

    @property
    def weight_dtype(self) -> str:
        """Storage dtype of the streamed weight blocks (all shards agree)."""
        return self.shards[0].weight_dtype

    @property
    def annealer_iters(self) -> int:
        return sum(s.annealer_iters for s in self.shards)

    @property
    def fallback_reason(self) -> Optional[str]:
        """Why the forward is not what was asked for: ``bsr_matmul`` has no
        occupancy gate, so a gated ``model > 1`` plan on ``kernel`` runs
        ungated; a one-shard plan reports its unsharded plan's reason."""
        if self.mesh.model == 1:
            return self.shards[0].fallback_reason
        if self.gate and self.backend != "torch":
            return _GATE_INACTIVE
        return None

    @property
    def route(self) -> str:
        """The lowering that really runs, as ``describe()`` names it."""
        if self.mesh.model == 1:
            fused = self.shards[0].fused and not self.layered
            route = "fused" if fused else "layered"
        else:
            route = ("bsr_matmul" if self.backend == "kernel"
                     else "segment") + "-per-shard"
        if self.process_mesh is not None:
            route += "+all_gather"
        return route

    @property
    def io(self) -> ShardedIOReport:
        return self.io_report()

    def io_report(self) -> ShardedIOReport:
        """Aggregate per-shard traffic + load-imbalance ratio."""
        return ShardedIOReport(per_shard=tuple(s.io for s in self.shards),
                               model=self.mesh.model, data=self.mesh.data)

    def __call__(self, x) -> torch.Tensor:
        """Run inference.  ``x`` is ``[n_in]`` or batched ``[B, n_in]``;
        the batch is padded up to a multiple of the data-axis size and
        sliced back (zero rows never perturb real rows)."""
        x, single = self.shards[0]._input(x)
        B = x.shape[0]
        pad = (-B) % self.mesh.data
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        if self.gate and self.mesh.model > 1:
            # the gated forward counts occupancy over the real rows only
            valid = torch.arange(x.shape[0], device=x.device) < B
            y = self._forward(x, valid)[:B]
        else:
            y = self._forward(x)[:B]
        self.calls += 1
        return y[0] if single else y

    def _lower(self) -> Callable:
        """A new forward for this plan's backend, gate and lowering."""
        base = None
        if self.mesh.model == 1:
            s0 = self.shards[0]
            base = dataclasses.replace(
                s0, backend=self.backend, gate=self.gate,
                flat=None if self.layered else s0.flat,
            ).with_fresh_forward()._forward
        return make_sharded_forward(
            self.segments, self.backend, self.mesh.data,
            gate=self.gate and self.backend == "torch",
            base_forward=base, process_mesh=self.process_mesh)

    def _relowered(self, **changes) -> "ShardedExecutionPlan":
        plan = dataclasses.replace(self, calls=0, **changes)
        plan._forward = plan._lower()
        return plan

    def with_fresh_forward(self) -> "ShardedExecutionPlan":
        """A copy with a newly lowered forward (call count 0); the shard
        schedules are shared by reference (the bucketed plan set's
        fan-out)."""
        return self._relowered()

    def safe_twin(self) -> "ShardedExecutionPlan":
        """The same shard schedules with the gate off, on the same backend:
        per shard and layer one ungated ``bsr_matmul`` on ``kernel`` (the
        primary's own route when ``model > 1``, so a breaker only counts),
        the segment lowering on ``torch``; a one-shard plan lowers per
        layer, as ``ExecutionPlan.safe_twin``."""
        return self._relowered(gate=False, layered=True)

    def plain(self) -> "ShardedExecutionPlan":
        """The plain PyTorch version: ``torch`` backend, gate off, the
        sequential loop — the ground truth kernel answers are held to."""
        return self._relowered(backend="torch", gate=False,
                               process_mesh=None)

    def with_process_group(self, group) -> "ShardedExecutionPlan":
        """The collective lowering: this process runs its own slot of the
        mesh in ``group`` (one process per slot, ranks laid out ``(data,
        model)``) and all-gathers activations over the model axis and
        outputs over the data axis, so every process returns the whole
        answer.  Collective to build (``Mesh.process_mesh``) and to call."""
        return self._relowered(process_mesh=self.mesh.process_mesh(group))

    def describe(self) -> str:
        shapes = " -> ".join(
            [str(self.n_in)]
            + [str(sum(s.layers[k].n_out for s in self.shards))
               for k in range(self.n_layers)])
        nnz = sum(l.nnz_blocks for s in self.shards for l in s.layers)
        mode = f"{self.backend}/{self.route}"
        if self.gate:
            mode += "+gated"
        if self.weight_dtype != "f32":
            mode += f"+{self.weight_dtype}"
        fallback = "" if self.fallback_reason is None \
            else f" [fallback: {self.fallback_reason}]"
        return (f"ShardedExecutionPlan[{mode} on {self.device}]{fallback} "
                f"mesh(model={self.mesh.model}, data={self.mesh.data}) "
                f"{shapes} ({self.n_layers} layers, {nnz} nonzero blocks); "
                + self.io_report().summary()
                + f"; compiled in {self.compile_s:.2f}s "
                  f"({self.annealer_iters} annealer iters), "
                  f"{self.calls} calls")

    def artifact_arrays(self) -> dict:
        """Persistable arrays: the partition assignment per layer plus each
        shard's own artifact, prefixed ``s{i}_`` — the plan-store entry for
        a sharded plan, the same keys and values as the reference's."""
        out = {}
        for k in range(self.n_layers):
            grid = sum(len(owned_s[k]) for owned_s in self.owned)
            assign = np.zeros(grid, dtype=np.int32)
            for s, owned_s in enumerate(self.owned):
                assign[owned_s[k]] = s
            out[f"assign_l{k}"] = assign
        for s, plan in enumerate(self.shards):
            for name, arr in plan.artifact_arrays().items():
                out[f"s{s}_{name}"] = arr
        return out


# --------------------------------------------------------------------------- #
# builder (called by Engine.compile — one shard through Engine._build each)
# --------------------------------------------------------------------------- #

def _on_host(flat):
    """A copy of a flat schedule with every tensor on the host."""
    if flat is None:
        return None
    return dataclasses.replace(flat, **{
        f.name: getattr(flat, f.name).cpu() for f in dataclasses.fields(flat)
        if isinstance(getattr(flat, f.name), torch.Tensor)})


def _sharded_segments(specs: Sequence[ShardSpec],
                      shard_plans: Sequence[ExecutionPlan]
                      ) -> List[ShardedSegment]:
    """Each layer's shard schedules, biases and owned tiles, on the plans'
    device."""
    device = shard_plans[0].device
    segments = []
    for k, full in enumerate(specs[0].bffnn.layers):
        segments.append(ShardedSegment(
            schedules=[p.schedules[k] for p in shard_plans],
            biases=[torch.as_tensor(sp.bffnn.layers[k].bias,
                                    dtype=torch.float32).to(device)
                    for sp in specs],
            owned=torch.as_tensor(np.stack([sp.owned[k] for sp in specs]),
                                  dtype=torch.int64).to(device),
            grid_in=full.grid_in,
            grid_out=sum(len(sp.owned[k]) for sp in specs),
            block_m=full.block_m,
            block_n=full.block_n,
            activation=shard_plans[0].activations[k],
        ))
    return segments


def build_sharded_plan(
    engine,                      # repro_torch.engine.Engine (duck-typed)
    bffnn: BlockFFNN,
    backend: str,
    mesh: Mesh,
    orders: Optional[Sequence[np.ndarray]] = None,
    ios: Optional[Sequence[IOReport]] = None,
) -> ShardedExecutionPlan:
    """Partition, build one per-shard plan each through ``engine._build``
    (Theorem-1 order + independent CR + packing + I/O report), then lower
    the sharded forward.

    ``orders``/``ios`` are the plan-store warm path: one stored connection
    order (and optionally I/O report) per shard, skipping the annealing and
    re-simulation as ``Engine.compile_with_order`` does.
    """
    t0 = time.perf_counter()
    specs = partition_model(bffnn, mesh.model)
    if orders is not None and len(orders) != len(specs):
        raise ValueError(
            f"got {len(orders)} stored orders for {len(specs)} shards")
    shard_plans = []
    for s, spec in enumerate(specs):
        if orders is not None:
            plan = engine._build(spec.bffnn, backend,
                                 order=np.asarray(orders[s]),
                                 io=None if ios is None else ios[s])
        else:
            plan = engine._build(spec.bffnn, backend)
        if mesh.model > 1:
            # shard layers read the gathered activation; the standalone
            # forwards _build lowered would mis-chain them, so none stays
            # callable, and the shard's flat schedule, which no launch
            # reads, keeps its arrays (the artifact) on the host only
            plan = dataclasses.replace(plan, _forward=_shard_not_runnable,
                                       _measure=None,
                                       flat=_on_host(plan.flat))
        shard_plans.append(plan)

    plan = ShardedExecutionPlan(
        mesh=mesh,
        shards=shard_plans,
        owned=[spec.owned for spec in specs],
        backend=backend,
        gate=engine.gate,
        block_ffnn=bffnn,
        segments=(_sharded_segments(specs, shard_plans)
                  if mesh.model > 1 else []),
    )
    if mesh.model == 1:
        # a one-shard mesh on one device IS the unsharded path: share the
        # very forward the single-device builder produced
        plan._forward = shard_plans[0]._forward
    else:
        plan._forward = plan._lower()
    plan.compile_s = time.perf_counter() - t0
    return plan
