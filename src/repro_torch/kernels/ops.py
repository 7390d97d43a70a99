"""Schedule packing for the Hopper kernels (port of ``repro.kernels.ops``).

``compile_schedule`` validates and packs one layer's block schedule;
``compile_flat_schedule`` concatenates every layer's schedule into the one
cross-layer :class:`FlatSchedule` the megakernel walks.  The packing logic is
the reference's numpy code, so every integer array is identical to the JAX
package's; the results are torch tensors on the plan's device.

Quantization runs with torch on the CPU (``torch.bfloat16`` and
``torch.float8_e4m3fn``; both round to nearest even, byte-for-byte what
``ml_dtypes`` gives the reference) and the result is then moved to the
device.

Beside the reference's fields, both schedules carry ``run_ptr``: the flat
start of each output-tile run (a maximal stretch of steps with one output
tile, i.e. the steps from a ``first`` flag to its ``last``), with the total
step count appended.  Both kernels split each step's block into K-slices
(``CompiledSchedule.split`` and ``FlatSchedule.split``, built here once)
and reduce each run's partials.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.blocksparse import BSRLayer, is_contiguous_by_output
from .bsr_matmul import (
    RowRuns,
    SplitPlan,
    bsr_matmul,
    row_runs,
    split_plan,
)

#: largest finite magnitude of float8_e4m3fn — the per-block fp8 scale maps
#: each block's absmax onto it
FP8_MAX = 448.0

WEIGHT_DTYPES = ("f32", "bf16", "fp8")

_WEIGHT_DTYPE_ALIASES = {
    None: "f32", "f32": "f32", "float32": "f32", "fp32": "f32",
    "bf16": "bf16", "bfloat16": "bf16",
    "fp8": "fp8", "f8": "fp8", "float8": "fp8", "float8_e4m3fn": "fp8",
}


def resolve_weight_dtype(name) -> str:
    """Normalize a weight-stream dtype spec to ``f32`` | ``bf16`` | ``fp8``."""
    key = name.lower() if isinstance(name, str) else name
    try:
        return _WEIGHT_DTYPE_ALIASES[key]
    except KeyError:
        raise ValueError(
            f"unknown weight_dtype {name!r}; pick from {WEIGHT_DTYPES}"
        ) from None


def weight_itemsize(weight_dtype: str) -> int:
    """Bytes per weight element in the streamed (storage) dtype."""
    return {"f32": 4, "bf16": 2, "fp8": 1}[resolve_weight_dtype(weight_dtype)]


def quantize_blocks(
    blocks: np.ndarray, weight_dtype: str
) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
    """Quantize ``[nnz, bm, bn]`` f32 blocks to the narrow storage dtype.

    Returns ``(qblocks, scales)``: ``qblocks`` a CPU tensor in the storage
    dtype, ``scales`` one f32 dequant factor per block (``None`` for f32).
    Dequant is ``q.float() * scale``.  bf16 keeps unit scales; fp8 maps each
    block's absmax onto ``FP8_MAX``.  All-zero blocks (the bias-patch blocks
    among them) get scale 1.0, so they dequantize to exact zero.
    """
    wdt = resolve_weight_dtype(weight_dtype)
    blocks = np.ascontiguousarray(blocks, dtype=np.float32)
    if wdt == "f32":
        return torch.from_numpy(blocks), None
    nnz = blocks.shape[0]
    if wdt == "bf16":
        return (torch.from_numpy(blocks).to(torch.bfloat16),
                np.ones(nnz, dtype=np.float32))
    amax = np.max(np.abs(blocks), axis=(1, 2))
    scales = np.where(amax > 0, amax / FP8_MAX, 1.0).astype(np.float32)
    q = blocks / scales[:, None, None]
    return torch.from_numpy(q).to(torch.float8_e4m3fn), scales


def _run_ptr(first: np.ndarray) -> np.ndarray:
    """Flat start of every output-tile run, plus the step count at the end."""
    return np.append(np.flatnonzero(first), len(first)).astype(np.int32)


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class CompiledSchedule:
    """A validated, kernel-ready block schedule for one BSR layer."""

    blocks: torch.Tensor   # [nnz', bm, bn] in schedule order (incl. patch blocks)
    rows: torch.Tensor     # int32 [nnz']
    cols: torch.Tensor     # int32 [nnz']
    first: torch.Tensor
    last: torch.Tensor
    grid_out: int
    # simulated tile traffic of this schedule (reads, writes) under the
    # single-resident-tile model — the paper's I/O count for M=3
    sim_reads: int
    sim_writes: int
    # quantized weight stream: ``blocks`` is stored in the narrow dtype and
    # ``scales`` holds one f32 dequant factor per block (None for f32)
    scales: Optional[torch.Tensor] = None
    weight_dtype: str = "f32"
    run_ptr: Optional[torch.Tensor] = None   # int32 [grid_out + 1]
    # the patch blocks: the last ``n_patch`` steps, one per output tile with
    # no kept block, each a run of its own
    n_patch: int = 0
    # bsr_matmul's work decomposition, its (step_run, part_off) rows as an
    # int32 [2, nnz'] tensor on the device, and its per-run arrival counters
    # (zero between launches; grown by the wrapper for larger batches)
    split: Optional[SplitPlan] = None
    split_index: Optional[torch.Tensor] = None
    arrivals: Optional[torch.Tensor] = None
    # held by the wrapper around the (re)allocation of ``arrivals`` and
    # the launch, so threads never share a launch's device state; every
    # launch goes to ``stream``, the CUDA stream of the first
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    stream: Optional[int] = None

    @property
    def weight_bytes(self) -> int:
        """Bytes the kernel streams for this layer's weight blocks."""
        return self.blocks.numel() * self.blocks.element_size()

    @property
    def scale_bytes(self) -> int:
        return 0 if self.scales is None else \
            self.scales.numel() * self.scales.element_size()


def compile_schedule(
    layer: BSRLayer,
    perm: Optional[np.ndarray] = None,
    weight_dtype: str = "f32",
    device="cpu",
) -> CompiledSchedule:
    """Validate + pack a schedule.  ``perm`` permutes the layer's block storage
    (default: as stored).  Raises if the schedule is not contiguous-by-output —
    the Theorem-1 family the kernels' per-run accumulator requires."""
    if perm is None:
        perm = np.arange(layer.nnz_blocks)
    perm = np.asarray(perm, dtype=np.int64)
    rows = layer.rows[perm].astype(np.int32)
    cols = layer.cols[perm].astype(np.int32)
    blocks = layer.blocks[perm]
    if not is_contiguous_by_output(cols):
        raise ValueError(
            "schedule is not contiguous by output tile; use a Theorem-1 "
            "(grouped-by-output) order — see core.blocksparse.schedule_arrays"
        )
    # patch: output tiles with no nonzero block still need bias+activation.
    present = np.zeros(layer.grid_out, dtype=bool)
    present[cols] = True
    missing = np.flatnonzero(~present).astype(np.int32)
    if len(missing):
        zero = np.zeros((len(missing), layer.block_m, layer.block_n), blocks.dtype)
        blocks = np.concatenate([blocks, zero])
        rows = np.concatenate([rows, np.zeros(len(missing), np.int32)])
        cols = np.concatenate([cols, missing])
    nnz = len(rows)
    first = np.zeros(nnz, np.int32)
    last = np.zeros(nnz, np.int32)
    first[0] = 1
    first[1:] = (cols[1:] != cols[:-1]).astype(np.int32)
    last[-1] = 1
    last[:-1] = (cols[1:] != cols[:-1]).astype(np.int32)
    # simulated tile I/O: weight blocks stream once each; an input tile is
    # re-read whenever rows[] changes; one write per output tile.
    row_changes = 1 + int((rows[1:] != rows[:-1]).sum()) if nnz else 0
    sim_reads = nnz + row_changes + layer.grid_out  # + bias tiles
    sim_writes = layer.grid_out
    qblocks, scales = quantize_blocks(blocks, weight_dtype)
    run_ptr = _run_ptr(first)
    split = split_plan(run_ptr, layer.block_m, layer.block_n,
                       qblocks.element_size())
    return CompiledSchedule(
        blocks=qblocks.to(device),
        rows=_on(device, rows),
        cols=_on(device, cols),
        first=_on(device, first),
        last=_on(device, last),
        grid_out=layer.grid_out,
        sim_reads=sim_reads,
        sim_writes=sim_writes,
        scales=None if scales is None else _on(device, scales),
        weight_dtype=resolve_weight_dtype(weight_dtype),
        run_ptr=_on(device, run_ptr),
        n_patch=len(missing),
        split=split,
        split_index=_on(device, np.stack([split.step_run, split.part_off])),
        arrivals=torch.zeros(layer.grid_out, dtype=torch.int32,
                             device=device),
    )


@dataclasses.dataclass
class FlatSchedule:
    """One whole-network block schedule: all layers' steps in one flat array.

    The per-step arrays are the per-layer ``CompiledSchedule`` arrays
    concatenated in layer order (each layer segment keeps its Theorem-1
    contiguous-by-output grouping), plus the reference's cross-layer arrays:

      * ``layer_id[g]`` — which layer step ``g`` belongs to;
      * ``hbm_row[g]`` / ``out_tile[g]`` — the TPU kernel's input/output
        index maps (kept for parity and ``artifact_arrays``; the CUDA
        megakernel addresses its tiles from ``rows``/``cols`` directly);
      * ``bias_idx[g]`` — row of ``bias_tiles`` ([total output tiles, bs])
        holding the bias of step ``g``'s output tile;

    and the port's derived run table ``run_ptr`` (flat start of every
    output-tile run, step count appended; every layer segment starts a
    run).  The megakernel walks each layer as ``bsr_matmul`` walks one: ``split`` is
    the split-K plan of the flat run table, ``split_index`` its
    (step_run, part_off) rows on the device and ``arrivals`` the per-run
    arrival counters (zero between launches; grown by the wrapper for
    larger batches).  ``row_runs`` is the row-tiled route's deal of the
    runs (``bsr_matmul.RowRuns``), ``row_order`` its run order on the
    device, a patch run flagged (``RowRuns.walk_order``).  ``slots`` and
    ``epoch`` are the gated launch's per-(layer, tile, row chunk) live-row
    counts, each tagged with the launch that wrote it.  ``launch_blocks``
    holds the megakernel's packed launch blocks (one per walk, x dtype,
    width and epilogues: what its launches share, built at the first of
    them) and ``scratch`` its f32 scratch, grown to the largest call and
    reused by every later one.
    ``lock`` guards all of these across threads; ``dataclasses.replace``
    gives the copy blocks and scratch of its own.

    ``segments[k] = (start, end)`` delimits layer ``k``'s steps; the ``torch``
    lowering consumes exactly these flat arrays one segment at a time, so all
    backends execute the identical connection order.
    """

    blocks: torch.Tensor       # [nnz_total, bs, bs] scheduled order
    rows: torch.Tensor         # int32 [nnz_total] layer-local input tile
    cols: torch.Tensor         # int32 [nnz_total] layer-local output tile
    first: torch.Tensor        # int32 [nnz_total]
    last: torch.Tensor         # int32 [nnz_total]
    layer_id: torch.Tensor     # int32 [nnz_total]
    hbm_row: torch.Tensor      # int32 [nnz_total]
    out_tile: torch.Tensor     # int32 [nnz_total]
    bias_idx: torch.Tensor     # int32 [nnz_total]
    bias_tiles: torch.Tensor   # f32 [sum(grid_out_k), bs]
    segments: Tuple[Tuple[int, int], ...]
    n_layers: int
    block: int                 # uniform tile size
    grid_out_final: int
    n_out: int
    hidden_tiles: int          # max tile count of any intermediate activation
    # simulated per-layer tile traffic (reads, writes)
    per_layer_io: Tuple[Tuple[int, int], ...]
    scales: Optional[torch.Tensor] = None
    weight_dtype: str = "f32"
    run_ptr: Optional[torch.Tensor] = None     # int32 [n_runs + 1]
    max_layer_steps: int = 0                   # most steps in any one layer
    split: Optional[SplitPlan] = None
    split_index: Optional[torch.Tensor] = None  # int32 [2, nnz_total]
    arrivals: Optional[torch.Tensor] = None     # int32 [n_runs * chunks]
    row_runs: Optional[RowRuns] = None
    row_order: Optional[torch.Tensor] = None    # int32 [n_runs]
    # the gated megakernel's occupancy slots (int64, epoch-tagged, kept
    # between launches; made anew by the wrapper when the row-chunk count
    # changes) and its launch count
    slots: Optional[torch.Tensor] = None
    epoch: int = 0
    # held by the wrapper around the (re)allocation of ``arrivals``,
    # ``slots`` and ``scratch``, the packing of a launch block, the epoch
    # bump and the launch; every launch goes to ``stream``, the CUDA stream
    # of the first
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    stream: Optional[int] = None
    launch_blocks: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    scratch: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def weight_bytes(self) -> int:
        """Bytes of weight blocks the megakernel streams per forward."""
        return self.blocks.numel() * self.blocks.element_size()

    @property
    def scale_bytes(self) -> int:
        return 0 if self.scales is None else \
            self.scales.numel() * self.scales.element_size()

    @property
    def sim_reads(self) -> int:
        return sum(r for r, _ in self.per_layer_io)

    @property
    def sim_writes(self) -> int:
        return sum(w for _, w in self.per_layer_io)


def compile_flat_schedule(
    layers: Sequence[BSRLayer],
    schedules: Sequence[CompiledSchedule],
) -> FlatSchedule:
    """Concatenate per-layer schedules into one megakernel-ready flat schedule.

    Requires one uniform square tile size across layers (layer k's output
    tiles are layer k+1's input tiles).  Raises ``ValueError`` otherwise — the
    engine falls back to per-layer dispatch in that case.  The result lives
    on the device of the schedules.
    """
    if not layers or len(layers) != len(schedules):
        raise ValueError("need one schedule per layer")
    bs = layers[0].block_m
    for lay in layers:
        if lay.block_m != bs or lay.block_n != bs:
            raise ValueError(
                "flat schedule requires one uniform square tile size across "
                f"layers; got ({lay.block_m}, {lay.block_n}) vs {bs}"
            )
    device = schedules[0].blocks.device

    rows_l: List[np.ndarray] = []
    cols_l: List[np.ndarray] = []
    first_l: List[np.ndarray] = []
    last_l: List[np.ndarray] = []
    lid_l: List[np.ndarray] = []
    segments: List[Tuple[int, int]] = []
    per_layer_io: List[Tuple[int, int]] = []
    off = 0
    for k, sch in enumerate(schedules):
        n = int(sch.rows.shape[0])
        rows_l.append(sch.rows.cpu().numpy())
        cols_l.append(sch.cols.cpu().numpy())
        first_l.append(sch.first.cpu().numpy())
        last_l.append(sch.last.cpu().numpy())
        lid_l.append(np.full(n, k, dtype=np.int32))
        segments.append((off, off + n))
        per_layer_io.append((sch.sim_reads, sch.sim_writes))
        off += n
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    first = np.concatenate(first_l)
    last = np.concatenate(last_l)
    layer_id = np.concatenate(lid_l)

    # hbm_row: live during layer 0, frozen afterwards (the TPU index map)
    n0 = segments[0][1]
    hbm_row = rows.copy()
    if off > n0:
        hbm_row[n0:] = hbm_row[n0 - 1]
    # out_tile: live during the final layer, pinned to its first output tile
    # before that (the TPU index map)
    fs, fe = segments[-1]
    out_tile = np.full(off, int(cols[fs]), dtype=np.int32)
    out_tile[fs:fe] = cols[fs:fe]
    # flat bias tiles + per-step bias row
    bias_off = np.zeros(len(layers) + 1, dtype=np.int64)
    for k, lay in enumerate(layers):
        bias_off[k + 1] = bias_off[k] + lay.grid_out
    bias_idx = (bias_off[layer_id] + cols).astype(np.int32)
    bias_tiles = np.concatenate(
        [np.asarray(lay.bias, dtype=np.float32).reshape(lay.grid_out, -1)
         for lay in layers])

    wdt = schedules[0].weight_dtype
    for sch in schedules:
        if sch.weight_dtype != wdt:
            raise ValueError(
                "flat schedule requires one weight_dtype across layers; got "
                f"{sch.weight_dtype!r} vs {wdt!r}"
            )
    scales = None if wdt == "f32" else \
        torch.cat([sch.scales for sch in schedules])

    # run table: every layer segment starts a run (first[start] == 1)
    run_ptr = _run_ptr(first)
    blocks = torch.cat([sch.blocks for sch in schedules])
    split = split_plan(run_ptr, bs, bs, blocks.element_size())
    live = np.concatenate([np.arange(e - s) < e - s - sch.n_patch
                           for (s, e), sch in zip(segments, schedules)])
    runs = row_runs(run_ptr, segments, live)

    hidden_tiles = max([lay.grid_out for lay in layers[:-1]] or [1])
    return FlatSchedule(
        blocks=blocks,
        rows=_on(device, rows),
        cols=_on(device, cols),
        first=_on(device, first),
        last=_on(device, last),
        layer_id=_on(device, layer_id),
        hbm_row=_on(device, hbm_row),
        out_tile=_on(device, out_tile),
        bias_idx=_on(device, bias_idx),
        bias_tiles=_on(device, bias_tiles),
        segments=tuple(segments),
        n_layers=len(layers),
        block=bs,
        grid_out_final=layers[-1].grid_out,
        n_out=layers[-1].n_out,
        hidden_tiles=int(hidden_tiles),
        per_layer_io=tuple(per_layer_io),
        scales=scales,
        weight_dtype=wdt,
        run_ptr=_on(device, run_ptr),
        max_layer_steps=max(e - s for s, e in segments),
        split=split,
        split_index=_on(device, np.stack([split.step_run, split.part_off])),
        arrivals=torch.zeros(len(run_ptr) - 1, dtype=torch.int32,
                             device=device),
        row_runs=runs,
        row_order=_on(device, runs.walk_order()),
    )


def scheduled_bsr_layer(
    x: torch.Tensor,
    layer: BSRLayer,
    schedule: Optional[CompiledSchedule] = None,
    activation: str = "none",
) -> torch.Tensor:
    """``y = act(x @ W_bsr + b)`` through the per-layer kernel wrapper (the
    CUDA kernel for a CUDA ``x``, its plain version for a CPU ``x``).
    ``activation`` is a name from ``kernels.bsr_matmul.ACTIVATION_CODES``."""
    if schedule is None:
        schedule = compile_schedule(layer, device=x.device)
    return bsr_matmul(x, schedule, torch.as_tensor(layer.bias, device=x.device),
                      activation=activation)

