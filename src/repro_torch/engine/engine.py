"""The fused multi-layer sparse inference engine (port of ``repro.engine.engine``).

    engine = Engine(reorder=True)            # runs on "cuda" by default
    plan = engine.compile(layers)            # offline: schedule + CR + packing
    y = plan(x)                              # online: one megakernel launch
    print(plan.io.summary())                 # predicted I/O vs Theorem-1 bounds

    sharded = engine.compile(layers, mesh=Mesh(model=4, data=2))

``compile`` builds the block DAG of all layers, takes the Theorem-1
(grouped-by-output) order, optionally improves it with Connection Reordering
over the entire DAG, re-groups the result into the kernel-compatible family,
packs per-layer schedules (and the flat cross-layer schedule) onto the
device, and lowers everything into one forward for the chosen backend.  The
offline steps are the reference's own code (``core`` is a verbatim copy),
so orders, schedule arrays and I/O reports equal the JAX package's.  Plans
are cached: compiling the same layers with the same settings returns the
same plan object.  With a ``mesh`` the net is partitioned into one plan
per model shard (``engine.sharding``).

A net may hold gate/up pair layers (``sparse.layers.GLULayer``): the core
sees each as the block DAG of its pair mask, so the Theorem-1 order and
Connection Reordering run on pairs unchanged, and the kernels walk a pair
as one step (``kernels.ops``).  Such a net compiles ungated, unsharded and
in float32 (weights and x) only; anything else raises at compile.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.blocksparse import (
    BlockFFNN,
    BSRLayer,
    regroup_by_output,
    schedule_arrays,
    to_block_ffnn,
)
from ..core.bounds import theorem1_bounds
from ..core.graph import drop_isolated
from ..core.iosim import simulate
from ..core.reorder import connection_reordering
from ..kernels.bsr_matmul import ACTIVATIONS as _KERNEL_ACTIVATIONS
from ..kernels.ops import (
    compile_flat_schedule,
    compile_schedule,
    is_pair,
    resolve_weight_dtype,
)
from ..obs.trace import NULL_TRACER
from .backends import (
    make_forward,
    make_fused_forward,
    make_fused_measure,
    resolve_backend,
)
from .plan import ExecutionPlan, IOReport
from .sharding import Mesh, ShardedExecutionPlan, build_sharded_plan

#: accepted epilogue names -> the kernels' canonical name ("none" = linear)
ACTIVATIONS: Dict[Optional[str], str] = {
    None: "none",
    "linear": "none",
    **{name: name for name in _KERNEL_ACTIVATIONS},
}


def _resolve_activation(act) -> Union[str, Callable]:
    if callable(act):
        return act
    try:
        return ACTIVATIONS[act]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown activation {act!r}; pick from "
            f"{sorted(k for k in ACTIVATIONS if isinstance(k, str))} "
            "or pass a callable (torch backend only)"
        ) from None


@dataclasses.dataclass
class Engine:
    """Compile-once/run-many engine for scheduled block-sparse inference.

    Args:
      backend: ``auto`` | ``kernel`` | ``torch``.  ``auto`` is ``kernel``:
        the hand-written CUDA kernels (their plain versions on the CPU).
      activation: epilogue of every layer but the last, by name (see
        ``ACTIVATIONS``; ``gelu`` is the tanh form, as in the reference) or
        a callable (``torch`` backend only).  A list/tuple gives each hidden
        layer its own; the megakernel fuses only when they all compare
        equal, otherwise the plan falls back to layered dispatch and
        records why in ``plan.fallback_reason``.
      final_activation: epilogue of the last layer (default linear).
      reorder / M_tiles / reorder_iters / seed / max_move_span / policy:
        Connection Reordering over the whole block DAG, as in the reference.
      fuse: lower the whole net into one megakernel launch per forward;
        ``fuse=False`` forces per-layer dispatch.  Nets with non-uniform
        tiles fall back to per-layer dispatch.
      gate: runtime tile-occupancy gating: a step whose input tile holds no
        nonzero for any batch row is skipped (the gated megakernel on
        ``kernel``, a masked gather on ``torch``); outputs stay
        bit-identical, and a gated fused plan can ``measure_dynamic``.  The
        layered ``kernel`` path has no gating and records that in
        ``plan.fallback_reason``.
      weight_dtype: storage dtype of the streamed weight blocks: ``"f32"``,
        ``"bf16"`` or ``"fp8"`` (one f32 dequant scale per block).
      device: where plans live and run.  ``"cuda"`` (the default) needs a
        CUDA device and raises without one; pass ``device="cpu"`` to run the
        kernels' plain versions on the CPU.
      tracer: a ``repro_torch.obs.Tracer`` recording compile-phase spans.
    """

    backend: str = "auto"
    activation: Union[str, Callable, None, Sequence] = "relu"
    final_activation: Union[str, Callable, None] = None
    reorder: bool = False
    M_tiles: int = 3
    reorder_iters: int = 2000
    seed: int = 0
    max_move_span: Optional[int] = None
    policy: str = "min"
    fuse: bool = True
    gate: bool = False
    weight_dtype: str = "f32"
    device: Union[str, torch.device] = "cuda"
    tracer: Optional[object] = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    _cache: Dict[Tuple, Union[ExecutionPlan, ShardedExecutionPlan]] = \
        dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to run the kernels' plain "
                "versions on the CPU")
        resolve_backend(self.backend)
        resolve_weight_dtype(self.weight_dtype)

    @property
    def _tr(self):
        tr = self.tracer
        return tr if tr is not None else NULL_TRACER

    # ------------------------------------------------------------------ #
    def compile(
        self,
        net: Union[BlockFFNN, Sequence[BSRLayer]],
        backend: Optional[str] = None,
        mesh: Optional[Mesh] = None,
    ) -> Union[ExecutionPlan, ShardedExecutionPlan]:
        """Lower a whole network into one cached plan.

        Without ``mesh``: one whole-network :class:`ExecutionPlan`.  With
        ``mesh=Mesh(model, data)`` the block DAG is partitioned over
        ``model`` and the batch over ``data`` into a
        :class:`ShardedExecutionPlan`, each shard built by the same
        ``_build`` (Theorem-1 order + its own Connection Reordering);
        ``Mesh(1, 1)`` shares the unsharded plan's forward outright.
        """
        bffnn = net if isinstance(net, BlockFFNN) else to_block_ffnn(list(net))
        backend = resolve_backend(backend or self.backend)
        self._check_pairs(bffnn, mesh)
        key = self._plan_key(bffnn, backend) + self._mesh_key(mesh)
        plan = self._cache.get(key)
        if plan is None:
            plan = self._build(bffnn, backend) if mesh is None \
                else build_sharded_plan(self, bffnn, backend, mesh)
            self._cache[key] = plan
        return plan

    def compile_with_order(
        self,
        net: Union[BlockFFNN, Sequence[BSRLayer]],
        order: np.ndarray,
        backend: Optional[str] = None,
        io: Optional[IOReport] = None,
    ) -> ExecutionPlan:
        """Lower a network onto a precomputed whole-DAG connection order:
        Theorem-1 grouping and Connection Reordering are skipped
        (``plan.annealer_iters == 0``); a stored ``io`` skips the I/O
        re-simulation too.  Deterministic: the same order gives the same
        plan."""
        bffnn = net if isinstance(net, BlockFFNN) else to_block_ffnn(list(net))
        backend = resolve_backend(backend or self.backend)
        self._check_pairs(bffnn, None)
        return self._build(bffnn, backend, order=np.asarray(order), io=io)

    def compile_sharded_with_orders(
        self,
        net: Union[BlockFFNN, Sequence[BSRLayer]],
        mesh: Mesh,
        orders: Sequence[np.ndarray],
        backend: Optional[str] = None,
        ios: Optional[Sequence[IOReport]] = None,
    ) -> ShardedExecutionPlan:
        """The sharded :meth:`compile_with_order`: a sharded plan rebuilt
        from one stored connection order per shard — zero annealer
        iterations, deterministic (the plan store's warm path)."""
        bffnn = net if isinstance(net, BlockFFNN) else to_block_ffnn(list(net))
        backend = resolve_backend(backend or self.backend)
        self._check_pairs(bffnn, mesh)
        return build_sharded_plan(self, bffnn, backend, mesh,
                                  orders=list(orders), ios=ios)

    def _check_pairs(self, bffnn: BlockFFNN, mesh: Optional[Mesh]) -> None:
        """Refuse what a net with a gate/up pair layer cannot run: gating,
        a mesh, narrow weights, and weights or inputs other than float32."""
        if not any(is_pair(lay) for lay in bffnn.layers):
            return
        why = None
        if self.gate:
            why = "gate=True (occupancy gating)"
        elif mesh is not None:
            why = f"a mesh ({mesh.model}x{mesh.data})"
        elif resolve_weight_dtype(self.weight_dtype) != "f32":
            why = f"weight_dtype={self.weight_dtype!r}"
        else:
            dtypes = {np.asarray(lay.blocks).dtype for lay in bffnn.layers}
            if dtypes != {np.dtype(np.float32)}:
                why = f"weights and x of dtype {sorted(map(str, dtypes))}"
        if why is not None:
            raise ValueError(
                f"a net with a gate/up pair layer cannot compile with {why}: "
                "it runs ungated, unsharded, with float32 weights and float32 "
                "x")

    @staticmethod
    def _mesh_key(mesh: Optional[Mesh]) -> Tuple:
        return ("mesh", None) if mesh is None \
            else ("mesh", mesh.model, mesh.data)

    @staticmethod
    def _act_key(act):
        # plans (hence their activations) stay strongly referenced by the
        # cache, so object ids cannot be recycled while an entry is alive.
        if isinstance(act, (str, type(None))):
            return act
        if isinstance(act, (list, tuple)):
            return tuple(Engine._act_key(a) for a in act)
        if isinstance(act, functools.partial):
            try:
                kw = tuple(sorted(act.keywords.items()))
                key = ("partial", Engine._act_key(act.func), act.args, kw)
                hash(key)
                return key
            except TypeError:
                return id(act)
        return id(act)

    def _plan_key(self, bffnn: BlockFFNN, backend: str) -> Tuple:
        return (
            tuple(id(l) for l in bffnn.layers), backend,
            self._act_key(self.activation),
            self._act_key(self.final_activation),
            self.reorder, self.M_tiles, self.reorder_iters, self.seed,
            self.max_move_span, self.policy, self.fuse, self.gate,
            resolve_weight_dtype(self.weight_dtype), str(self.device),
        )

    # ------------------------------------------------------------------ #
    def _build(self, bffnn: BlockFFNN, backend: str,
               order: Optional[np.ndarray] = None,
               io: Optional[IOReport] = None) -> ExecutionPlan:
        t0 = time.perf_counter()
        tr = self._tr
        layers = bffnn.layers
        wdt = resolve_weight_dtype(self.weight_dtype)
        annealer_iters = 0
        if order is None:
            order = self.schedule_order(bffnn)
            annealer_iters = self.reorder_iters if self.reorder else 0
        with tr.span("compile.pack", layers=len(layers)):
            schedules = []
            for k in range(len(layers)):
                perm, _, _, _, _ = schedule_arrays(bffnn, order, k)
                schedules.append(compile_schedule(layers[k], perm,
                                                  weight_dtype=wdt,
                                                  device=self.device))

        if isinstance(self.activation, (list, tuple)):
            if len(self.activation) != len(layers) - 1:
                raise ValueError(
                    f"per-layer activation sequence has {len(self.activation)} "
                    f"entries but the net has {len(layers) - 1} hidden layers"
                )
            hidden = [_resolve_activation(a) for a in self.activation]
        else:
            hidden = [_resolve_activation(self.activation)] * (len(layers) - 1)
        activations: List[object] = hidden + [
            _resolve_activation(self.final_activation)]

        with tr.span("compile.lower", backend=backend,
                     gate=self.gate) as sp:
            flat = None
            fallback_reason: Optional[str] = None
            if self.fuse:
                try:
                    flat = compile_flat_schedule(layers, schedules)
                except ValueError as e:
                    fallback_reason = str(e)   # non-uniform tiles
            measure = None
            if flat is not None:
                try:
                    forward = make_fused_forward(layers, flat, activations,
                                                 backend, gate=self.gate)
                    if self.gate:
                        measure = make_fused_measure(layers, flat,
                                                     activations, backend)
                except ValueError as e:
                    # heterogeneous hidden epilogues: the megakernel fuses
                    # exactly one — record why instead of failing silently
                    flat = None
                    fallback_reason = str(e)
            if flat is None:
                forward = make_forward(layers, schedules, activations,
                                       backend, gate=self.gate)
                if self.gate and backend != "torch":
                    # the reference's own words, kept for parity
                    note = ("occupancy gating inactive on the layered "
                            "pallas path")
                    fallback_reason = f"{fallback_reason}; {note}" \
                        if fallback_reason else note
            sp["fused"] = flat is not None
        if io is None:
            with tr.span("compile.io_report", policy=self.policy,
                         M_tiles=self.M_tiles):
                io = self.io_report(bffnn, order, schedules,
                                    fused=flat is not None)
        return ExecutionPlan(
            layers=list(layers),
            schedules=schedules,
            activations=activations,
            backend=backend,
            order=order,
            block_ffnn=bffnn,
            io=io,
            device=self.device,
            flat=flat,
            gate=self.gate,
            fallback_reason=fallback_reason,
            _forward=forward,
            _measure=measure,
            compile_s=time.perf_counter() - t0,
            annealer_iters=annealer_iters,
        )

    def schedule_order(self, bffnn: BlockFFNN) -> np.ndarray:
        """Whole-DAG connection order: Theorem-1 grouping, then optional CR
        re-grouped back into the kernel-compatible 2-optimal family."""
        tr = self._tr
        with tr.span("compile.theorem1") as sp:
            order = bffnn.net.theorem1_order()
            sp["connections"] = int(len(order))
        if self.reorder:
            with tr.span("compile.reorder", iters=self.reorder_iters,
                         M_tiles=self.M_tiles,
                         max_move_span=self.max_move_span):
                res = connection_reordering(
                    bffnn.net, order, M=self.M_tiles, policy=self.policy,
                    T=self.reorder_iters, seed=self.seed,
                    max_move_span=self.max_move_span,
                )
                order = regroup_by_output(bffnn.net, res.order)
        return order

    def io_report(self, bffnn: BlockFFNN, order: np.ndarray,
                  schedules: Optional[List] = None,
                  fused: bool = False) -> IOReport:
        """Exact simulated tile traffic of ``order`` next to Theorem 1 (the
        reference's accounting: isolated tiles dropped, weight-stream bytes
        in the storage dtype, f32 activation bytes per batch row, and for a
        fused plan the layered traffic it avoids)."""
        net = drop_isolated(bffnn.net)
        sim = simulate(net, order, self.M_tiles, self.policy)
        layered_reads = layered_writes = 0
        hidden_tiles = hidden_bytes = 0
        weight_dtype = "f32"
        weight_bytes = scale_bytes = act_bytes = 0
        if schedules is not None:
            weight_dtype = schedules[0].weight_dtype
            weight_bytes = sum(s.weight_bytes for s in schedules)
            scale_bytes = sum(s.scale_bytes for s in schedules)
            act_bytes = 4 * (bffnn.layers[0].n_in + bffnn.layers[-1].n_out)
            if not fused:
                act_bytes += sum(2 * lay.n_out * 4
                                 for lay in bffnn.layers[:-1])
        if schedules is not None and fused:
            layered_reads = sum(s.sim_reads for s in schedules)
            layered_writes = sum(s.sim_writes for s in schedules)
            for lay in bffnn.layers[:-1]:
                hidden_tiles += lay.grid_out
                hidden_bytes += 2 * lay.n_out * 4
        return IOReport(
            simulated=sim,
            bounds=theorem1_bounds(net),
            M_tiles=self.M_tiles,
            policy=self.policy,
            layered_reads=layered_reads,
            layered_writes=layered_writes,
            hidden_tiles_kept=hidden_tiles,
            hidden_bytes_kept_per_row=hidden_bytes,
            weight_dtype=weight_dtype,
            weight_bytes_streamed=weight_bytes,
            scale_bytes_streamed=scale_bytes,
            activation_bytes_per_row=act_bytes,
        )
