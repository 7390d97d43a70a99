"""The two hand-written Hopper kernels, their plain versions and launch counts.

``bsr_matmul`` replaces the Pallas kernel
``repro.kernels.bsr_matmul.bsr_matmul`` (one layer per launch) and
``bsr_megakernel`` replaces ``repro.kernels.bsr_matmul.bsr_megakernel`` (the
whole net per launch), ungated and, with ``gate=True``, gated on runtime
tile occupancy.  Both are CUDA C++ for ``sm_90a``, in ``csrc/bsr_matmul.cu``
and ``csrc/bsr_kernels.cu``, which share their block walk
(``csrc/split_k.cuh``); ``_build`` compiles them with ``nvcc`` at first use
and binds them through ctypes.  Each source's header notes what bounds its
kernel on the H100 and what its design does about it.  ``split_plan`` is
that walk's work decomposition (step, K-slice, row chunk), built once per
schedule by ``ops.compile_schedule`` and ``ops.compile_flat_schedule``.
A large batch takes the megakernel's second route instead, the row-tiled
walk (``csrc/row_tile.cuh``): ``row_tiled(B, flat)`` chooses it from
the batch and the schedule alone, and ``row_runs`` is the order in which it
deals out each layer's runs, built once per flat schedule.

Each wrapper dispatches on the device of ``x``: a CUDA tensor launches the
kernel on the current stream of its device (or raises — there is no
fallback), a CPU tensor runs the plain PyTorch version beside it.

The megakernel's launch is prepared once per flat schedule: its first
launch with a given walk, x dtype, width and pair of epilogues checks the
schedule's tensors and packs every argument that later launches share into
a launch block (``bsr_megakernel_prepare``, kept in
``FlatSchedule.launch_blocks``; while tracing is active each packing adds 1
to the ``mega.pack`` counter of ``obs.trace``), and its f32 scratch stays
with the schedule (``FlatSchedule.scratch``).  A call then checks only what
its caller can change (x's device, dtype, width, rank and layout, and
``occ0``) and passes the launch its own values
(``bsr_megakernel_prepared_launch``).

The wrappers are safe to call from several threads.  A schedule keeps device
state that its launches share — the split-K arrival counters, which each
launch leaves at zero, and the gated instance's epoch-tagged occupancy
slots — so each schedule object holds a lock, and the (re)allocation of that
state, the epoch bump and the launch happen under it; the epoch goes to the
kernel from a local, never re-read.  The lock orders launches on the host
only: two launches of one schedule must not overlap on the card either, so
all launches of a schedule go to one CUDA stream, the one its first launch
used (another raises).  A Python thread starts on the default stream, so
serving threads share it: they overlap host work (batch formation, copies,
``.cpu()``), not kernels, and none may set a stream of its own.  The plain versions
walk the schedule step by step with the kernels' ``first``/``last``
semantics, accumulate in f32 and keep hidden activations in f32; they are
what the kernels are checked against on the card, and what the CPU tests
run.  Their products assume PyTorch's default full-f32 matmul
(``torch.backends.cuda.matmul.allow_tf32`` False).

``bsr_matmul.launches`` / ``bsr_megakernel.launches`` count kernel launches
and ``bsr_megakernel.gated_launches`` the gated megakernel's (plain-version
calls are not counted), exactly under concurrency;
``bsr_megakernel.row_tiled_launches`` counts the megakernel launches, gated
or not, that took the row-tiled route (and, while tracing is active, each
adds 1 to the ``mega.row_tiled`` counter of ``obs.trace``, and its patch
items, patch runs x row tiles, to ``mega.patch_items``);
``reset_launches()`` zeroes all four.  While tracing is active a launch of a
schedule with a gate/up pair layer adds 1 to ``mega.glu_launches`` and the
pair steps it stages to ``mega.glu_pairs``: live pair steps x 64-row tiles
on the row-tiled walk, every pair step x 32-row chunks on the split-K walk.
``bsr_megakernel.grid`` is the cooperative grid size of the last launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..obs import trace as _trace
from . import _build

Activation = Union[str, Callable, None]


def _squared_relu(y: torch.Tensor) -> torch.Tensor:
    r = torch.relu(y)
    return r * r


def _gelu(y: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh form; F.gelu's default is erf
    return F.gelu(y, approximate="tanh")


#: epilogue name -> torch function (None = identity); the kernels' table
ACTIVATIONS = {
    "none": None,
    "relu": torch.relu,
    "gelu": _gelu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "squared_relu": _squared_relu,
}

#: epilogue name -> the integer the CUDA kernels switch on (keep in step
#: with ``enum Act`` in csrc/common.cuh)
ACTIVATION_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bsr_matmul's grid is (steps x K-slices, row chunks of kChunkRows = 32
# rows); CUDA caps the second grid dimension at 65535
_ROWS_PER_CTA = 32
_MAX_GRID_Y = 65535
_W_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# keep in step with csrc/bsr_matmul.cu: threads per CTA, weight vectors a
# thread holds, and the tallest K-slice
_SPLIT_THREADS, _SPLIT_MAX_VEC, _SPLIT_MAX_ROWS = 128, 8, 32
# the megakernel takes its layer table by value (kMaxLayers, csrc/mega.cuh)
_MEGA_MAX_LAYERS = 32
# the row-tiled route (csrc/row_tile.cuh): the block sizes it has
# instances for, the batch rows of its items (kRowBM), and the least items
# (runs x row tiles) that every layer needs for the route, set from a
# sweep of B on the H100 (PERF.md)
_ROW_BLOCKS = (64, 128)
_ROW_BM = 64
_ROW_MIN_ITEMS = 16


def apply_activation(y: torch.Tensor, act: Activation) -> torch.Tensor:
    """Apply an epilogue given by name (the kernels' table) or callable."""
    if act is None:
        return y
    if callable(act):
        return act(y)
    try:
        fn = ACTIVATIONS[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; pick from "
                         f"{sorted(ACTIVATIONS)}") from None
    return y if fn is None else fn(y)


def activation_code(act: Activation) -> int:
    """The kernels' integer code of an epilogue name."""
    if act is None:
        return ACTIVATION_CODES["none"]
    if callable(act):
        raise ValueError(
            "the CUDA kernels take an activation by name "
            f"({sorted(ACTIVATION_CODES)}), not a callable — use the 'torch' "
            "backend for a custom epilogue")
    try:
        return ACTIVATION_CODES[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; pick from "
                         f"{sorted(ACTIVATION_CODES)}") from None


# guards the launch counts: ``+=`` on an attribute is not atomic across
# threads
_COUNTS = threading.Lock()


def count_launch(fn, name: str = "launches") -> None:
    """Add one to the wrapper ``fn``'s launch count ``fn.<name>``."""
    with _COUNTS:
        setattr(fn, name, getattr(fn, name) + 1)


def reset_launches() -> None:
    """Zero the kernels' launch counts."""
    with _COUNTS:
        bsr_matmul.launches = 0
        bsr_megakernel.launches = 0
        bsr_megakernel.gated_launches = 0
        bsr_megakernel.row_tiled_launches = 0


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernels cut one schedule (a layer's, or the flat one) into
    work items.

    Work item (step ``g``, K-slice ``s``, chunk of 32 batch rows); step
    ``g``'s slice ``s`` covers block rows ``s * k_slice`` up to
    ``min(bm, (s + 1) * k_slice)`` and writes partial number
    ``part_off[g] + s``.  ``step_run[g]`` is the output-tile run of step
    ``g``; the last CTA of a run to finish sums the run's partials in
    schedule order, then K-slice order.  ``vec`` is the number of weight
    elements one thread loads at once (16 bytes' worth, or 1 where a block
    row is not a multiple of 16 bytes).  A pair step (``wide[g]``, a
    ``[bm, 2 * bn]`` gate/up block) writes partials twice as wide, so it
    takes two partial numbers a slice: its slice ``s`` writes
    ``part_off[g] + 2 s``.
    """

    step_run: np.ndarray   # int32 [n_steps]
    part_off: np.ndarray   # int32 [n_steps]
    k_slice: int
    n_slices: int
    vec: int
    wide: Optional[np.ndarray] = None   # bool [n_steps]: the pair steps

    @property
    def n_parts(self) -> int:
        n = len(self.part_off)
        if self.wide is not None:
            n += int(np.count_nonzero(self.wide))
        return n * self.n_slices


def split_plan(run_ptr, bm: int, bn: int, itemsize: int,
               wide=None) -> SplitPlan:
    """The split-K work decomposition of a schedule with run table
    ``run_ptr`` and ``[bm, bn]`` blocks of ``itemsize``-byte weights;
    ``wide`` (bool per step) marks pair steps, whose partials take two
    numbers a slice (``bn`` is then the pair's width)."""
    run_ptr = np.asarray(run_ptr, dtype=np.int64)
    vec = 16 // itemsize if (bn * itemsize) % 16 == 0 else 1
    groups = bn // vec                      # column groups of a block row
    if groups > _SPLIT_THREADS:
        raise ValueError(f"bsr_matmul: blocks {bn} wide in {itemsize}-byte "
                         f"weights exceed the kernel's {_SPLIT_THREADS} "
                         "column groups")
    row_groups = _SPLIT_THREADS // groups
    k_slice = min(bm, _SPLIT_MAX_ROWS, _SPLIT_MAX_VEC * row_groups)
    n_slices = -(-bm // k_slice)
    n_steps = int(run_ptr[-1])
    step_run = np.repeat(np.arange(len(run_ptr) - 1), np.diff(run_ptr))
    if wide is None:
        part_off = np.arange(n_steps) * n_slices
    else:
        wide = np.asarray(wide, dtype=bool)
        size = n_slices * (1 + wide.astype(np.int64))
        part_off = np.concatenate([[0], np.cumsum(size)[:-1]])
    return SplitPlan(step_run=step_run.astype(np.int32),
                     part_off=part_off.astype(np.int32),
                     k_slice=k_slice, n_slices=n_slices, vec=vec, wide=wide)


@dataclasses.dataclass(frozen=True)
class RowRuns:
    """The order in which the megakernel's row-tiled route deals out a flat
    schedule's runs.

    ``live[r]`` counts run ``r``'s live steps: every step but a patch block
    (the zero block that ``ops.compile_schedule`` gives an output tile with
    no kept block, so that its epilogue writes ``act(bias)``).  A patch run
    has none: the walk writes its tiles with no stage.  ``order`` lists each
    layer's output-tile runs by live steps, longest first (ties in schedule
    order), so patch runs come last; layer after layer, layer ``k``'s are
    ``order[first[k]:first[k + 1]]``.  A work item is (run, row tile); item
    ``i`` of layer ``k`` is row tile ``i % nt`` of run
    ``order[first[k] + i // nt]``, and the CTAs take the items in rounds,
    forward then backward (``csrc/row_tile.cuh``).  ``pair_steps`` counts
    the live steps of the pair layers: an item of one stages that many
    (gate, up) blocks.
    """

    order: np.ndarray          # int32 [n_runs]
    first: Tuple[int, ...]     # [n_layers + 1]
    fewest: int                # runs of the layer with the fewest
    live: np.ndarray           # int32 [n_runs]
    pair_steps: int = 0

    @property
    def patch_runs(self) -> int:
        """The runs with no live step."""
        return int(np.count_nonzero(self.live == 0))

    def walk_order(self) -> np.ndarray:
        """``order`` as the kernel reads it: a patch run ``r`` as ``~r``."""
        return np.where(self.live[self.order] > 0, self.order,
                        ~self.order).astype(np.int32)


def row_runs(run_ptr, segments, live, pairs=()) -> RowRuns:
    """The row-tiled deal of a flat schedule with run table ``run_ptr``,
    layer ``segments`` (every layer starts a run), ``live`` (per step,
    False on a patch block) and ``pairs`` (per layer, True for a pair
    layer)."""
    run_ptr = np.asarray(run_ptr, dtype=np.int64)
    starts = run_ptr[:-1]
    n_live = np.add.reduceat(np.asarray(live, dtype=np.int64), starts)
    first = [int(np.searchsorted(starts, s)) for s, _ in segments]
    first.append(len(starts))
    order = [np.arange(a, b)[np.argsort(-n_live[a:b], kind="stable")]
             for a, b in zip(first[:-1], first[1:])]
    live = np.asarray(live, dtype=bool)
    pair_steps = sum(int(live[s:e].sum())
                     for (s, e), p in zip(segments, pairs) if p)
    return RowRuns(order=np.concatenate(order).astype(np.int32),
                   first=tuple(first),
                   fewest=min(b - a for a, b in zip(first[:-1], first[1:])),
                   live=n_live.astype(np.int32), pair_steps=pair_steps)


def row_tiled(B: int, flat) -> bool:
    """Whether a ``B``-row call of ``flat`` takes the megakernel's row-tiled
    walk (else the split-K walk).

    A function of ``B`` and the schedule alone.  Batches of up to 32 rows
    (one split-K row chunk: the serving batches) always take the split-K
    walk, and so do blocks the row-tiled kernel has no instance for.
    Otherwise the call takes the row-tiled walk when every layer has at
    least ``_ROW_MIN_ITEMS`` items, runs x row tiles.
    """
    runs = flat.row_runs
    if runs is None or flat.block not in _ROW_BLOCKS or B <= _ROWS_PER_CTA:
        return False
    return runs.fewest * -(-B // _ROW_BM) >= _ROW_MIN_ITEMS


def megakernel_scratch_floats(B: int, flat, rows: bool) -> int:
    """The f32 scratch of one megakernel launch, in floats: the hidden
    ping-pong buffer [2, hidden_tiles, B, block] and, on the split-K walk
    (``rows`` False), the partials [steps x K-slices, B, block]."""
    n = 2 * flat.hidden_tiles * B * flat.block
    return n if rows else n + flat.split.n_parts * B * flat.block


def _dequant(blocks: torch.Tensor, scales: Optional[torch.Tensor]):
    w = blocks.float()
    return w if scales is None else w * scales[:, None, None]


def _check_cuda(name: str, x: torch.Tensor, tensors: dict) -> None:
    """Validate what the kernel takes; raise on anything else."""
    _check_x(name, x)
    _check_tensors(name, x.device, tensors)


def _check_x(name: str, x: torch.Tensor) -> None:
    """Validate x's device and dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on the CPU or a CUDA device, "
                         f"got {x.device}")
    if x.dtype not in _X_CODES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")


def _check_tensors(name: str, device: torch.device, tensors: dict) -> None:
    """Validate the device, layout and dtype of each of ``tensors`` (None
    entries skipped); ``blocks``, when given, holds the weights."""
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key in ("rows", "cols", "run_ptr", "bias_idx", "occ0", "split_index",
                "row_order"):
        t = tensors.get(key)
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name}: {key} must be int32, got {t.dtype}")
    for key in ("bias", "bias_tiles", "scales"):
        t = tensors.get(key)
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
    blocks = tensors.get("blocks")
    if blocks is not None and blocks.dtype not in _W_CODES:
        raise ValueError(f"{name}: blocks must be float32, bfloat16 or "
                         f"float8_e4m3fn, got {blocks.dtype}")


def _stream(index: int) -> int:
    """The raw handle of CUDA device ``index``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


def _schedule_stream(schedule, name: str, index: int) -> int:
    """The current stream of CUDA device ``index``, which must be the one
    the schedule's launches use (lock held): its shared device state is
    ordered by that stream."""
    stream = _stream(index)
    if schedule.stream is None:
        schedule.stream = stream
    elif schedule.stream != stream:
        raise RuntimeError(
            f"{name}: launched on stream {stream:#x}, but this schedule's "
            f"launches go to stream {schedule.stream:#x}; its arrival "
            "counters and occupancy slots are shared by its launches, which "
            "must not overlap on the card")
    return stream


def next_epoch(flat) -> int:
    """Bump the flat schedule's gated-launch epoch and return it (lock
    held): a tag that is never 0 and repeats only after 2**32 - 1
    launches."""
    flat.epoch = flat.epoch % 0xFFFFFFFF + 1
    return flat.epoch


# --------------------------------------------------------------------------- #
# one layer per launch
# --------------------------------------------------------------------------- #

def bsr_matmul_plain(x: torch.Tensor, schedule, bias: torch.Tensor,
                     activation: Activation = "none") -> torch.Tensor:
    """Plain version of ``bsr_matmul``: the schedule walked step by step."""
    B = x.shape[0]
    _, bm, bn = schedule.blocks.shape
    w = _dequant(schedule.blocks, schedule.scales)
    xf = x.float()
    b = bias.float()
    out = torch.empty((B, schedule.grid_out * bn), dtype=x.dtype,
                      device=x.device)
    rows, cols = schedule.rows.tolist(), schedule.cols.tolist()
    first, last = schedule.first.tolist(), schedule.last.tolist()
    acc = None
    for g, r in enumerate(rows):
        if first[g]:
            acc = torch.zeros((B, bn), dtype=torch.float32, device=x.device)
        acc = acc + xf[:, r * bm:(r + 1) * bm] @ w[g]
        if last[g]:
            c = cols[g]
            y = apply_activation(acc + b[c * bn:(c + 1) * bn], activation)
            out[:, c * bn:(c + 1) * bn] = y.to(x.dtype)
    return out


def bsr_matmul(x: torch.Tensor, schedule, bias: torch.Tensor,
               activation: Activation = "none") -> torch.Tensor:
    """``y = act(x @ W_bsr + b)`` for one layer's ``CompiledSchedule``.

    ``x`` [B, n_in] is float32 or bfloat16 (any B); the output is
    [B, grid_out * bn] in ``x.dtype``.  Weight blocks may be float32,
    bfloat16 or float8_e4m3fn, dequantized by ``schedule.scales``.  On the
    card the f32 partials ([steps x K-slices, B, bn]) are allocated here
    with ``torch.empty``; the schedule's arrival counters are shared by its
    launches, which therefore go to one stream, under ``schedule.lock``.
    """
    B, n_in = x.shape
    _, bm, bn = schedule.blocks.shape
    if n_in % bm:
        raise ValueError("n_in must be a multiple of the block size")
    if x.device.type == "cpu":
        return bsr_matmul_plain(x, schedule, bias, activation)
    act = activation_code(activation)
    _check_cuda("bsr_matmul", x, dict(
        blocks=schedule.blocks, rows=schedule.rows, cols=schedule.cols,
        run_ptr=schedule.run_ptr, bias=bias, scales=schedule.scales, x=x))
    if B > _MAX_GRID_Y * _ROWS_PER_CTA:
        raise ValueError(f"bsr_matmul: batch {B} exceeds the kernel's grid "
                         f"({_MAX_GRID_Y * _ROWS_PER_CTA} rows); split it")
    n_runs = schedule.run_ptr.numel() - 1
    if n_runs != schedule.grid_out:
        raise ValueError(f"bsr_matmul: {n_runs} output-tile runs for "
                         f"{schedule.grid_out} output tiles; compile the "
                         "schedule with compile_schedule (it patches empty "
                         "tiles)")
    n_out = schedule.grid_out * bn
    if bias.numel() != n_out:
        raise ValueError(f"bsr_matmul: bias has {bias.numel()} entries for "
                         f"{n_out} outputs")
    split, index = schedule.split, schedule.split_index
    if split is None or index is None or index.device != x.device:
        raise ValueError("bsr_matmul: the schedule has no split plan on "
                         f"{x.device}; compile it with compile_schedule")
    out = torch.empty((B, n_out), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    _launch_matmul(x, schedule, bias, act, out)
    return out


def _launch_matmul(x, schedule, bias, act: int, out) -> None:
    """``bsr_matmul``'s launch on checked tensors, with its bookkeeping."""
    B, n_in = x.shape
    _, bm, bn = schedule.blocks.shape
    split, index = schedule.split, schedule.split_index
    n_runs = schedule.run_ptr.numel() - 1
    chunks = -(-B // _ROWS_PER_CTA)
    partial = torch.empty((split.n_parts, B, bn), dtype=torch.float32,
                          device=x.device)
    scales = schedule.scales
    with schedule.lock:
        stream = _schedule_stream(schedule, "bsr_matmul", x.get_device())
        if schedule.arrivals is None or \
                schedule.arrivals.numel() < n_runs * chunks:
            # zero between launches: the last CTA of each run resets it
            schedule.arrivals = torch.zeros(n_runs * chunks,
                                            dtype=torch.int32,
                                            device=x.device)
        rc = _build.load().bsr_matmul_launch(
            _X_CODES[x.dtype], _W_CODES[schedule.blocks.dtype],
            x.data_ptr(), schedule.blocks.data_ptr(),
            schedule.rows.data_ptr(), schedule.cols.data_ptr(),
            schedule.run_ptr.data_ptr(), index[0].data_ptr(),
            index[1].data_ptr(), bias.data_ptr(),
            None if scales is None else scales.data_ptr(),
            partial.data_ptr(), schedule.arrivals.data_ptr(),
            out.data_ptr(), B, n_in, out.shape[1], bm, bn,
            int(schedule.rows.numel()), split.k_slice, split.n_slices,
            split.vec, act, stream)
    if rc:
        raise RuntimeError(f"bsr_matmul: kernel launch failed, CUDA error {rc}")
    count_launch(bsr_matmul)


bsr_matmul.launches = 0


# --------------------------------------------------------------------------- #
# the whole net per launch
# --------------------------------------------------------------------------- #

def bsr_megakernel_plain(x: torch.Tensor, flat,
                         activation: Activation = "none",
                         final_activation: Activation = "none",
                         gate: bool = False,
                         occ0: Optional[torch.Tensor] = None):
    """Plain version of ``bsr_megakernel``: the flat schedule walked step by
    step, hidden tiles kept in two f32 ping-pong buffers.  With ``gate`` a
    step whose input tile has occupancy 0 skips its product, each hidden
    epilogue counts the live rows of the tile it wrote, and the result is
    ``(y, occ)``.  A pair layer's step adds its product to a [B, 2 * bs]
    accumulator (gate, then up), and its epilogue writes
    ``act(gate + bg) * (up + bu)``."""
    B = x.shape[0]
    bs = flat.block
    pairs = flat.pairs
    if any(pairs):
        # a list of per-step blocks: a pair step's is [bs, 2 * bs]
        w = [blk for k in range(flat.n_layers)
             for blk in flat.layer_blocks(k).float()]
    else:
        w = _dequant(flat.blocks, flat.scales)
    xf = x.float()
    out = torch.empty((B, flat.grid_out_final * bs), dtype=x.dtype,
                      device=x.device)
    hidden = torch.zeros((2, flat.hidden_tiles, B, bs), dtype=torch.float32,
                         device=x.device)
    if gate:
        occ = torch.zeros((max(1, flat.n_layers - 1), flat.hidden_tiles),
                          dtype=torch.int32, device=x.device)
        occ_in = [occ0.tolist()] + [None] * (flat.n_layers - 1)
    lids, rows, cols = (flat.layer_id.tolist(), flat.rows.tolist(),
                        flat.cols.tolist())
    first, last = flat.first.tolist(), flat.last.tolist()
    bias_idx = flat.bias_idx.tolist()
    final = flat.n_layers - 1
    acc = None
    for g, (lid, r) in enumerate(zip(lids, rows)):
        if first[g]:
            acc = torch.zeros((B, 2 * bs if pairs[lid] else bs),
                              dtype=torch.float32, device=x.device)
        if gate and occ_in[lid] is None:     # layer lid-1 is complete
            occ_in[lid] = occ[lid - 1].tolist()
        if not gate or occ_in[lid][r] > 0:
            src = xf[:, r * bs:(r + 1) * bs] if lid == 0 \
                else hidden[(lid - 1) % 2, r]
            acc = acc + src @ w[g]
        if last[g]:
            c = cols[g]
            a = final_activation if lid == final else activation
            if pairs[lid]:
                y = acc + flat.bias_tiles[bias_idx[g]:bias_idx[g] + 2
                                          ].reshape(-1)
                h = apply_activation(y[:, :bs], a) * y[:, bs:]
            else:
                y = acc + flat.bias_tiles[bias_idx[g]]
                h = apply_activation(y, a)
            if lid == final:
                out[:, c * bs:(c + 1) * bs] = h.to(x.dtype)
            else:
                hidden[lid % 2, c] = h
                if gate:                     # rows with any nonzero
                    occ[lid, c] = (h != 0).any(dim=1).sum()
    return (out, occ) if gate else out


def bsr_megakernel(x: torch.Tensor, flat,
                   activation: Activation = "none",
                   final_activation: Activation = "none",
                   gate: bool = False,
                   occ0: Optional[torch.Tensor] = None):
    """The whole net of a ``FlatSchedule`` in one launch.

    ``activation`` is the one hidden epilogue, ``final_activation`` the last
    layer's.  ``x`` [B, n_in] is float32 or bfloat16 (any B); the output is
    [B, grid_out_final * block] in ``x.dtype``.  On the card the f32 scratch
    (``megakernel_scratch_floats``: the hidden ping-pong buffer and, on the
    split-K walk, the partials) is the flat schedule's, grown to the
    largest call.  ``row_tiled(B, flat)`` picks the walk; the row-tiled one
    reads ``x`` with 16-byte copies, so a view that is not 16-byte aligned
    takes the split-K walk.  The flat schedule's scratch, arrival counters
    and occupancy slots are shared by its launches, which therefore go to
    one stream, under ``flat.lock``.

    With ``gate=True`` the call takes ``occ0`` (int32 [grid_in_0], the
    live-row counts of x's input tiles, on x's device) and returns
    ``(y, occ)``: ``occ`` (int32 [max(1, n_layers-1), hidden_tiles]) holds
    the live-row counts of every hidden tile, as the kernel measured them
    and gated on.  ``y`` is bit-identical to the ungated output.  The
    kernel writes every entry of ``occ``, so it is allocated with
    ``torch.empty``; the per-chunk counts it sums live in the flat
    schedule's ``slots``, tagged with the launch's ``epoch``.
    """
    B, n_in = x.shape
    bs = flat.block
    if n_in % bs:
        raise ValueError("n_in must be a multiple of the block size")
    grid_in0 = n_in // bs
    if gate:
        if occ0 is None or tuple(occ0.shape) != (grid_in0,):
            raise ValueError(f"bsr_megakernel: gate=True needs occ0 of "
                             f"shape [{grid_in0}]")
        if flat.has_pairs:
            raise ValueError("bsr_megakernel: a schedule with a gate/up pair "
                             "layer runs ungated")
    if x.is_cpu:
        if flat.has_pairs:
            check_pair_x(x.dtype)
        return bsr_megakernel_plain(x, flat, activation, final_activation,
                                    gate, occ0)
    act = activation_code(activation)
    fact = activation_code(final_activation)
    # what the caller can change; the schedule's own tensors are checked
    # once, when a launch block is packed
    if not x.is_cuda or x.dtype not in _X_CODES:
        _check_x("bsr_megakernel", x)
    if not x.is_contiguous():
        raise ValueError("bsr_megakernel: x must be contiguous")
    if gate:
        _check_tensors("bsr_megakernel", x.device, dict(occ0=occ0))
    n_occ = max(1, flat.n_layers - 1)
    out = x.new_empty((B, flat.grid_out_final * bs))
    if B == 0:
        _check_flat(x.device, flat)
        occ = x.new_zeros((n_occ, flat.hidden_tiles), dtype=torch.int32)
        return (out, occ) if gate else out
    occ = x.new_empty((n_occ, flat.hidden_tiles), dtype=torch.int32) \
        if gate else None
    _launch_megakernel(x, flat, act, fact, occ0 if gate else None, occ, out)
    return (out, occ) if gate else out


def check_pair_x(dtype: torch.dtype) -> None:
    """A net with a gate/up pair layer takes float32 x only."""
    if dtype != torch.float32:
        raise ValueError("a net with a gate/up pair layer takes float32 x, "
                         f"got {dtype}")


def _check_flat(device: torch.device, flat) -> None:
    """Validate what the megakernel takes of a flat schedule on
    ``device``; raise on anything else."""
    name = "bsr_megakernel"
    _check_tensors(name, device, dict(
        blocks=flat.blocks, rows=flat.rows, cols=flat.cols,
        run_ptr=flat.run_ptr, bias_idx=flat.bias_idx,
        bias_tiles=flat.bias_tiles, scales=flat.scales,
        row_order=flat.row_order))
    split, index = flat.split, flat.split_index
    if split is None or index is None or index.device != device:
        raise ValueError("bsr_megakernel: the flat schedule has no split "
                         f"plan on {device}; compile it with "
                         "compile_flat_schedule")
    _check_tensors(name, device, dict(split_index=index))
    if flat.n_layers > _MEGA_MAX_LAYERS:
        raise ValueError(f"bsr_megakernel: {flat.n_layers} layers; the "
                         f"kernel takes at most {_MEGA_MAX_LAYERS} (compile "
                         "with fuse=False for deeper nets)")


def _launch_megakernel(x, flat, act: int, fact: int, occ0, occ, out) -> None:
    """``bsr_megakernel``'s launch on checked inputs, with its bookkeeping;
    gated when ``occ`` is given."""
    B, n_in = x.shape
    gate = occ is not None
    rows = row_tiled(B, flat) and x.data_ptr() % 16 == 0
    key = (rows, x.dtype, n_in, act, fact)
    packed = flat.launch_blocks.get(key)
    if packed is None or packed.device != x.device:
        packed = _pack(flat, key, x.device)
    chunks = -(-B // _ROWS_PER_CTA)
    need = megakernel_scratch_floats(B, flat, rows)
    with flat.lock:
        stream = _schedule_stream(flat, "bsr_megakernel", x.get_device())
        arrivals = None
        if not rows:
            if flat.arrivals is None or \
                    flat.arrivals.numel() < packed.runs * chunks:
                # zero between launches: the last CTA of each run resets it
                flat.arrivals = torch.zeros(packed.runs * chunks,
                                            dtype=torch.int32,
                                            device=x.device)
            arrivals = flat.arrivals.data_ptr()
        epoch, slots = 0, None
        if gate:
            # one slot per (hidden layer, tile, row chunk), zeroed anew when
            # the chunk count changes, so that each keeps one meaning; the
            # kernel tells this launch's slots by its epoch
            n_slots = occ.numel() * chunks
            if flat.slots is None or flat.slots.numel() != n_slots:
                flat.slots = torch.zeros(n_slots, dtype=torch.int64,
                                         device=x.device)
            slots = flat.slots.data_ptr()
            epoch = next_epoch(flat)
        if flat.scratch is None or flat.scratch.numel() < need:
            # launches of the schedule are ordered on one stream, so each
            # reuses the scratch after the one before it
            flat.scratch = torch.empty(need, dtype=torch.float32,
                                       device=x.device)
        grid = packed.launch(
            packed.address, x.data_ptr(), out.data_ptr(),
            flat.scratch.data_ptr(), B, stream, arrivals,
            occ0.data_ptr() if gate else None, slots,
            occ.data_ptr() if gate else None, epoch)
        if grid > 0:
            with _COUNTS:
                bsr_megakernel.grid = grid
                if gate:
                    bsr_megakernel.gated_launches += 1
                else:
                    bsr_megakernel.launches += 1
                if rows:
                    bsr_megakernel.row_tiled_launches += 1
    if grid <= 0:
        raise RuntimeError(
            f"bsr_megakernel: kernel launch failed, CUDA error {-grid}")
    if rows:
        _trace.count("mega.row_tiled")
        if packed.patch_runs:
            _trace.count("mega.patch_items",
                         packed.patch_runs * -(-B // _ROW_BM))
    if packed.pair_steps:
        _trace.count("mega.glu_launches")
        _trace.count("mega.glu_pairs", packed.pair_steps * -(
            -B // (_ROW_BM if rows else _ROWS_PER_CTA)))


#: bytes the caller holds for one launch block (``mega::Block`` in
#: csrc/mega.cuh, under 450)
_MEGA_BLOCK_BYTES = 512


@dataclasses.dataclass(frozen=True)
class _Packed:
    """One packed launch block of a flat schedule and what its calls need
    beside it: the device it was packed for, the block's address (its
    memory held by ``block``), the launch entry, the run count, on the
    row-tiled walk the patch runs, whose items it writes with no stage, and
    the pair steps the walk stages per row tile (row-tiled: the live ones;
    split-K: all, per 32-row chunk)."""

    device: torch.device
    address: int
    block: ctypes.Array
    launch: Callable
    runs: int
    patch_runs: int
    pair_steps: int


def _pack(flat, key, device: torch.device) -> _Packed:
    """Check ``flat`` on ``device`` and pack its launch block for ``key``
    (walk, x dtype, width, epilogue codes) into ``flat.launch_blocks``."""
    rows, x_dtype, n_in, act, fact = key
    with flat.lock:
        packed = flat.launch_blocks.get(key)
        if packed is not None and packed.device == device:
            return packed
        _check_flat(device, flat)
        pair_layers, unit_off = 0, [0] * flat.n_layers
        if flat.has_pairs:
            check_pair_x(x_dtype)
            pair_layers = sum(1 << k for k, p in enumerate(flat.pairs) if p)
            unit_off = flat.unit_offsets()
        split, index, lib = flat.split, flat.split_index, _build.load()
        if rows:
            seg = flat.row_runs.first
        else:
            seg = [s for s, _ in flat.segments] + [flat.segments[-1][1]]
        block = ctypes.create_string_buffer(_MEGA_BLOCK_BYTES)
        scales, order = flat.scales, flat.row_order
        rc = lib.bsr_megakernel_prepare(
            block, _MEGA_BLOCK_BYTES, int(rows), _X_CODES[x_dtype],
            _W_CODES[flat.blocks.dtype], split.vec, flat.blocks.data_ptr(),
            flat.rows.data_ptr(), flat.cols.data_ptr(),
            flat.run_ptr.data_ptr(), index[0].data_ptr(),
            index[1].data_ptr(), None if order is None else order.data_ptr(),
            flat.bias_idx.data_ptr(), flat.bias_tiles.data_ptr(),
            None if scales is None else scales.data_ptr(), n_in,
            flat.grid_out_final * flat.block, flat.block, flat.n_layers,
            flat.hidden_tiles, split.k_slice, split.n_slices,
            flat.max_layer_steps, act, fact,
            (ctypes.c_int * len(seg))(*seg), pair_layers,
            (ctypes.c_int * len(unit_off))(*unit_off))
        if rc:
            raise RuntimeError(f"bsr_megakernel: packing its launch failed, "
                               f"CUDA error {rc}")
        packed = _Packed(device, ctypes.addressof(block), block,
                         lib.bsr_megakernel_prepared_launch,
                         flat.run_ptr.numel() - 1,
                         flat.row_runs.patch_runs if rows else 0,
                         flat.row_runs.pair_steps if rows
                         else flat.pair_steps)
        flat.launch_blocks[key] = packed
    _trace.count("mega.pack")
    return packed


bsr_megakernel.launches = 0
bsr_megakernel.gated_launches = 0
bsr_megakernel.row_tiled_launches = 0
bsr_megakernel.grid = 0
