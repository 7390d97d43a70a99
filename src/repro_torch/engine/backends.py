"""Execution backends for compiled plans (port of ``repro.engine.backends``).

Two ways to run the same flat cross-layer schedule:

  * ``kernel`` — the hand-written CUDA kernels: one ``bsr_megakernel``
                 launch per forward for fused plans, one ``bsr_matmul``
                 launch per layer for layered ones (the counterpart of
                 ``pallas``/``interpret``).  On CPU tensors the kernel
                 wrappers run their plain PyTorch versions.
  * ``torch``  — a segment lowering of the same flat arrays in plain
                 PyTorch: ``index_select`` gather, a batched f32 block
                 product, an ``index_add_`` segment sum, then bias and
                 epilogue (the counterpart of ``jnp``; also the safe twin).

Both consume the same schedule arrays, so the connection order is identical
across backends; only the machinery that walks it differs.  ``auto``
resolves to ``kernel``.  The kernels take their epilogues by name; a
callable epilogue is accepted on the ``torch`` backend only.

``gate`` turns on runtime tile-occupancy gating: a step whose input tile
holds no nonzero for any batch row contributes nothing, so the gated
megakernel (``kernel``) skips it and the ``torch`` lowering masks its
gather; both stay bit-identical to the ungated forward.

``make_sharded_forward`` lowers a sharded plan (``engine.sharding``): per
layer one ``bsr_matmul`` launch per model shard on ``kernel``, the segment
lowering on ``torch``, as a loop on one device or one shard per process.

A gate/up pair layer (``sparse.layers.GLULayer``) is one step kind more:
fused, the megakernel and the segment lowering walk its pair steps and
write ``act(gate + bg) * (up + bu)`` once; layered, one ``bsr_matmul`` (or
segment pass) runs its ``[gate | up]`` layer with no epilogue and the
product follows in plain PyTorch (:func:`glu`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence

import torch

from ..core.blocksparse import BSRLayer
from ..kernels.bsr_matmul import (
    Activation,
    activation_code,
    apply_activation,
    bsr_matmul,
    bsr_megakernel,
    check_pair_x,
)
from ..kernels.ops import (
    CompiledSchedule,
    FlatSchedule,
    is_pair,
    wide_schedule,
)

BACKENDS = ("kernel", "torch")


def resolve_backend(name: str) -> str:
    """Resolve ``auto`` (and validate) to a concrete backend name."""
    if name == "auto":
        return "kernel"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; pick from {('auto',) + BACKENDS}")
    return name


def tile_occupancy(h: torch.Tensor, block: int, grid: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-input-tile live-row counts of an activation: ``occ[t]`` is the
    number of batch rows with any nonzero in tile ``t`` (``valid`` [B] bool
    restricts the count to real batch rows)."""
    B = h.shape[0]
    live = h.reshape(B, grid, block) != 0
    if valid is not None:
        live = live & valid.reshape(B, 1, 1)
    return live.any(dim=2).sum(dim=0).to(torch.int32)


def activations_equal(a, b) -> bool:
    """Value-level equality for epilogues (names or callables); partials
    compare structurally, anything ambiguous counts as not equal."""
    if a is b:
        return True
    if isinstance(a, functools.partial) and isinstance(b, functools.partial):
        try:
            return (activations_equal(a.func, b.func)
                    and bool(a.args == b.args)
                    and bool(a.keywords == b.keywords))
        except (TypeError, ValueError):
            return False
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


def _check_kernel_activations(activations: Sequence[Activation]) -> None:
    for act in activations:
        activation_code(act)   # raises for a callable or an unknown name


# --------------------------------------------------------------------------- #
# per-layer dispatch (layered path + fallback for non-uniform tiles)
# --------------------------------------------------------------------------- #

def glu(y: torch.Tensor, activation: Activation, n: int) -> torch.Tensor:
    """``act(y[..., :n]) * y[..., n:]``: a pair layer's epilogue on the
    output of its ``[gate | up]`` layer (biases added)."""
    return apply_activation(y[..., :n], activation) * y[..., n:]


def _torch_segment(
    x: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    blocks: torch.Tensor,
    bias: torch.Tensor,
    bm: int,
    bn: int,
    grid_in: int,
    grid_out: int,
    activation: Activation,
    occ: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    pair: bool = False,
) -> torch.Tensor:
    """One schedule segment as gather -> block product -> segment sum.

    Accumulates in f32 and dequantizes narrow blocks per block right before
    the product (``scales`` [nnz] f32), the same f32 weight values the
    kernels produce.  ``index_add_`` sums in another order than the
    reference's ``segment_sum``, so f32 parity is a tolerance, not bits.

    ``occ`` ([grid_in] int32, from :func:`tile_occupancy`) masks the gather:
    a step whose input tile is dead contributes a hard zero instead of its
    (already all +-0) tile, which leaves every bit of the result as it was.

    ``pair``: the segment's steps are pair steps ([bm, 2 * bn] blocks, two
    bias tiles per output tile, the gate's then the up's), and an output
    tile is ``act(gate + bg) * (up + bu)``.
    """
    B = x.shape[0]
    xt = x.float().reshape(B, grid_in, bm).transpose(0, 1)        # [gi, B, bm]
    gathered = xt.index_select(0, rows.long())                    # [nnz, B, bm]
    if occ is not None:
        live = (occ.index_select(0, rows.long()) > 0).to(gathered.dtype)
        gathered = gathered * live[:, None, None]
    w = blocks.float()
    if scales is not None:
        w = w * scales[:, None, None]
    contrib = torch.bmm(gathered, w)                              # [nnz, B, bn]
    if pair:                                               # [nnz, B, 2 bn]
        y = torch.zeros((grid_out, B, 2 * bn), dtype=torch.float32,
                        device=x.device)
        y.index_add_(0, cols.long(), contrib)
        y = y.transpose(0, 1) + bias.float().reshape(grid_out, 2 * bn)
        return glu(y, activation, bn).reshape(B, grid_out * bn).to(x.dtype)
    y = torch.zeros((grid_out, B, bn), dtype=torch.float32, device=x.device)
    y.index_add_(0, cols.long(), contrib)
    y = y.transpose(0, 1).reshape(B, grid_out * bn) + bias.float()
    return apply_activation(y, activation).to(x.dtype)


def make_forward(
    layers: Sequence[BSRLayer],
    schedules: Sequence[CompiledSchedule],
    activations: Sequence[Activation],
    backend: str,
    gate: bool = False,
) -> Callable:
    """Per-layer dispatch forward: x [B, n_in] -> [B, n_out].

    One ``bsr_matmul`` launch (or one ``torch`` segment pass) per layer —
    the layered path, and the fallback for nets the flat schedule cannot
    express (non-uniform tiles) or the megakernel cannot fuse (mixed hidden
    epilogues).  ``gate`` masks each layer's gather on the ``torch``
    backend only: ``bsr_matmul`` has no occupancy gating (the engine records
    that on the plan's fallback reason).  A pair layer runs its ``[gate |
    up]`` layer (``ops.wide_schedule``, built here) with no epilogue, then
    :func:`glu`.
    """
    layers = list(layers)
    schedules = list(schedules)
    activations = list(activations)
    gate = gate and backend == "torch"
    if backend == "kernel":
        _check_kernel_activations(activations)
    device = schedules[0].blocks.device
    biases = [torch.as_tensor(lay.wide_bias() if is_pair(lay) else lay.bias,
                              dtype=torch.float32).to(device)
              for lay in layers]
    wides = [wide_schedule(sch, lay.n_in) if sch.pair else None
             for lay, sch in zip(layers, schedules)]
    pairs = any(sch.pair for sch in schedules)

    def forward(x):
        if pairs:
            check_pair_x(x.dtype)
        h = x
        for layer, sch, act, bias, wide in zip(layers, schedules,
                                               activations, biases, wides):
            if wide is not None:
                if backend == "torch":
                    occ = tile_occupancy(h, layer.block_m, layer.grid_in) \
                        if gate else None
                    y = _torch_segment(h, wide.rows, wide.cols, wide.blocks,
                                       bias, layer.block_m, layer.block_n,
                                       layer.grid_in, wide.grid_out, None,
                                       occ=occ, scales=wide.scales)
                else:
                    y = bsr_matmul(h, wide, bias, None)
                h = glu(y, act, layer.n_out)
            elif backend == "torch":
                occ = tile_occupancy(h, layer.block_m, layer.grid_in) \
                    if gate else None
                h = _torch_segment(h, sch.rows, sch.cols, sch.blocks, bias,
                                   layer.block_m, layer.block_n,
                                   layer.grid_in, layer.grid_out, act,
                                   occ=occ, scales=sch.scales)
            else:
                h = bsr_matmul(h, sch, bias, act)
        return h

    return forward


# --------------------------------------------------------------------------- #
# fused dispatch: the whole net as one flat schedule
# --------------------------------------------------------------------------- #

def _check_fusible_activations(activations: Sequence[Activation]) -> None:
    """The megakernel fuses ONE hidden epilogue; equal-but-distinct
    callables (per-layer partials with the same bound args) count as one."""
    hidden = list(activations[:-1])
    distinct = sum(1 for a in hidden[1:] if not activations_equal(hidden[0], a))
    if distinct:
        raise ValueError(
            "the megakernel fuses ONE hidden-layer activation; got "
            f"{distinct + 1} distinct hidden epilogues — use fuse=False "
            "(per-layer dispatch) for heterogeneous activations"
        )


def _flat_segments(layers, flat: FlatSchedule, activations) -> List[tuple]:
    """Per-layer views of the flat arrays, materialized once."""
    segs = []
    bias_row = 0
    pairs = flat.pairs
    for k, (s, e) in enumerate(flat.segments):
        lay = layers[k]
        n_bias = (2 if pairs[k] else 1) * lay.grid_out
        bias = flat.bias_tiles[bias_row:bias_row + n_bias].reshape(-1)
        scales = None if flat.scales is None else flat.scales[s:e]
        segs.append((flat.rows[s:e], flat.cols[s:e], flat.layer_blocks(k),
                     scales, bias, lay.grid_in, lay.grid_out,
                     activations[k], pairs[k]))
        bias_row += n_bias
    return segs


def make_fused_forward(
    layers: Sequence[BSRLayer],
    flat: FlatSchedule,
    activations: Sequence[Activation],
    backend: str,
    gate: bool = False,
) -> Callable:
    """Whole-network fused forward over one ``FlatSchedule``.

    ``kernel``: a single ``bsr_megakernel`` launch (the gated one with
    ``gate``, fed the layer-0 occupancy computed on the device).
    ``torch``: the identical flat arrays consumed segment by segment.
    """
    layers = list(layers)
    activations = list(activations)
    _check_fusible_activations(activations)
    act = activations[0] if len(activations) > 1 else None
    fact = activations[-1]
    bs = flat.block

    if backend == "torch":
        segs = _flat_segments(layers, flat, activations)

        def forward_torch(x):
            if flat.has_pairs:
                check_pair_x(x.dtype)
            h = x
            for rows, cols, blocks, scales, bias, gi, go, a, pair in segs:
                occ = tile_occupancy(h, bs, gi) if gate else None
                h = _torch_segment(h, rows, cols, blocks, bias, bs, bs, gi,
                                   go, a, occ=occ, scales=scales, pair=pair)
            return h

        return forward_torch

    _check_kernel_activations([act, fact])
    grid_in0 = layers[0].grid_in

    def forward(x):
        if gate:
            occ0 = tile_occupancy(x, bs, grid_in0)
            return bsr_megakernel(x, flat, act, fact, gate=True, occ0=occ0)[0]
        return bsr_megakernel(x, flat, act, fact)

    return forward


def make_fused_measure(
    layers: Sequence[BSRLayer],
    flat: FlatSchedule,
    activations: Sequence[Activation],
    backend: str,
) -> Callable:
    """Instrumented gated fused forward: ``x -> (y, occs)``.

    ``occs[k]`` ([grid_in_k] int32) is the live-row count per input tile of
    layer ``k`` — the counts the gated forward's predicates consumed.  The
    ``torch`` lowering recomputes them with :func:`tile_occupancy`; the
    ``kernel`` lowering takes layer 0's from ``tile_occupancy`` and layers
    >= 1 from the gated megakernel's own occupancy output.
    ``ExecutionPlan.measure_dynamic`` turns these into the dynamic I/O
    report.
    """
    layers = list(layers)
    activations = list(activations)
    _check_fusible_activations(activations)
    act = activations[0] if len(activations) > 1 else None
    fact = activations[-1]
    bs = flat.block

    if backend == "torch":
        segs = _flat_segments(layers, flat, activations)

        def measure_torch(x):
            h = x
            occs = []
            for rows, cols, blocks, scales, bias, gi, go, a, pair in segs:
                occ = tile_occupancy(h, bs, gi)
                occs.append(occ)
                h = _torch_segment(h, rows, cols, blocks, bias, bs, bs, gi,
                                   go, a, occ=occ, scales=scales, pair=pair)
            return h, tuple(occs)

        return measure_torch

    _check_kernel_activations([act, fact])
    grid_ins = [lay.grid_in for lay in layers]

    def measure(x):
        occ0 = tile_occupancy(x, bs, grid_ins[0])
        y, occ = bsr_megakernel(x, flat, act, fact, gate=True, occ0=occ0)
        occs = (occ0,) + tuple(occ[k, :grid_ins[k + 1]]
                               for k in range(flat.n_layers - 1))
        return y, occs

    return measure


# --------------------------------------------------------------------------- #
# sharded dispatch: per-shard layers + the activation's reassembly
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ShardedSegment:
    """One layer of a sharded plan: every model shard's compiled schedule
    and bias, and ``owned[s]`` (int64 [tps]), the layer's output tiles
    shard ``s`` computes, in its local order.

    The reference stacks the shards' schedules, padded with sink steps to
    one length, because ``shard_map`` needs equal shapes; the shard loop
    and the per-process lowering walk each shard's own schedule and need
    none of that.
    """

    schedules: List[CompiledSchedule]   # [model]
    biases: List[torch.Tensor]          # [model] f32 [tps * bn]
    owned: torch.Tensor                 # int64 [model, tps]
    grid_in: int                        # full input grid of this layer
    grid_out: int                       # full output grid of this layer
    block_m: int
    block_n: int
    activation: Activation

    @property
    def tps(self) -> int:
        """Output tiles per shard."""
        return int(self.owned.shape[1])


def _shard_layer(h: torch.Tensor, seg: ShardedSegment, s: int, backend: str,
                 occ: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shard ``s``'s owned tiles of one layer from the full activation
    ``h``: one ``bsr_matmul`` launch on ``kernel``, the segment lowering on
    ``torch``."""
    sch = seg.schedules[s]
    if backend == "torch":
        return _torch_segment(h, sch.rows, sch.cols, sch.blocks,
                              seg.biases[s], seg.block_m, seg.block_n,
                              seg.grid_in, seg.tps, seg.activation, occ=occ,
                              scales=sch.scales)
    return bsr_matmul(h, sch, seg.biases[s], seg.activation)


def _place(out: torch.Tensor, y: torch.Tensor, seg: ShardedSegment,
           s: int) -> None:
    """Write shard ``s``'s [B, tps * bn] output into its owned tiles of
    ``out`` ([B, grid_out, bn]): data movement only, so bit-exact."""
    out.index_copy_(1, seg.owned[s],
                    y.reshape(y.shape[0], seg.tps, seg.block_n))


def make_sharded_forward(
    segments: Sequence[ShardedSegment],
    backend: str,
    data: int = 1,
    gate: bool = False,
    base_forward: Optional[Callable] = None,
    process_mesh=None,
) -> Callable:
    """Sharded forward over a model x data mesh: x [B, n_in] -> [B, n_out].

    Per layer, each model shard computes its owned output tiles from the
    full previous activation, and the tiles are put back in canonical order
    for the next layer.  ``segments`` empty means a one-shard model axis:
    the body is ``base_forward``, the unsharded plan's own.

    Without ``process_mesh`` the shards run one after another on this
    device (on ``kernel``, ``model x layers`` ``bsr_matmul`` launches, all
    on the current stream).  With one (a ``sharding.ProcessMesh``) this
    process runs its own shard on its data rows, ``torch.distributed``
    all-gathers each layer's shard outputs over the model axis and the
    answers over the data axis; ``B`` must then be a multiple of ``data``
    (the plan pads).

    With ``gate`` (``torch`` only) the forward takes ``(x, valid)``:
    ``valid`` ([B] bool) marks the real batch rows, and each layer's
    occupancy, counted once over them, masks every shard's gather.
    """
    segments = list(segments)
    if not segments and base_forward is None:
        raise ValueError("a one-shard mesh needs the unsharded forward")
    model = len(segments[0].schedules) if segments else 1

    def forward_loop(x, valid=None):
        h = x
        for seg in segments:
            occ = tile_occupancy(h, seg.block_m, seg.grid_in, valid=valid) \
                if gate else None
            out = torch.empty((h.shape[0], seg.grid_out, seg.block_n),
                              dtype=h.dtype, device=h.device)
            for s in range(model):
                _place(out, _shard_layer(h, seg, s, backend, occ), seg, s)
            h = out.reshape(h.shape[0], -1)
        return h

    if process_mesh is None:
        return forward_loop if segments else base_forward

    import torch.distributed as dist

    pm = process_mesh

    def gather(t: torch.Tensor, n: int, group) -> List[torch.Tensor]:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts

    def forward_collective(x, valid=None):
        rows = x.shape[0] // data
        lo = pm.data_index * rows
        h = x[lo:lo + rows]
        v = None if valid is None else valid[lo:lo + rows]
        if not segments:
            h = base_forward(h)
        for seg in segments:
            occ = tile_occupancy(h, seg.block_m, seg.grid_in, valid=v) \
                if gate else None
            y = _shard_layer(h, seg, pm.model_index, backend, occ)
            out = torch.empty((h.shape[0], seg.grid_out, seg.block_n),
                              dtype=h.dtype, device=h.device)
            for s, ys in enumerate(gather(y, model, pm.model_group)):
                _place(out, ys, seg, s)
            h = out.reshape(h.shape[0], -1)
        if data > 1:
            h = torch.cat(gather(h, data, pm.data_group))
        return h

    return forward_collective
