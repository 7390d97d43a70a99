"""Roofline terms of one device's step, from a trace on ``meta`` tensors.

Counterpart of ``repro.launch.hlo_analysis``, which parses the compiled
per-device HLO.  The port has no HLO: ``analyze_step`` runs one rank's step
on ``meta`` tensors (shapes and dtypes, no data, nothing computed) under a
dispatch mode that counts

  * matmul FLOPs as ``torch.utils.flop_counter.FlopCounterMode`` counts
    them (its formula registry and its decomposition rule);
  * collective calls and operand bytes from ``models.sharding.STATS``
    (each rank's input, as the reference sums operand bytes), under the
    reference's HLO names;
  * live bytes: every storage the step allocates, from its allocation to
    the death of its last tensor (storages are followed by
    ``weakref.finalize``; a ``meta`` tensor's ``data_ptr()`` is 0).

Loops the port unrolls where the reference scans (``models.tripcount``)
run their first iterations, the last of them standing for the rest: its FLOPs and
collectives (forward, the remat's recompute and backward) count its trip
count, and its live bytes as the other iterations would add them, until
what it left alive is freed.  The reference's ``analyze_module`` counts a
``while`` body once times its trip count in the same way.

Hardware model: NVIDIA H100 80GB HBM3 (SXM), from its data sheet, not
measured: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM,
450 GB/s per direction over NVLink 4.  They replace the reference's TPU v5e
constants.  One link rate serves every collective, as in the reference: a
16-wide ``model`` axis spans two 8-GPU nodes on a real cluster, whose links
between nodes are slower, so there the collective term is a lower bound.

    compute    = flops_per_device / 989e12
    memory     = bytes_per_device / 3.35e12
    collective = coll_bytes_per_device / 450e9
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models import tripcount
from ..models.sharding import STATS

PEAK_FLOPS = 989e12       # bf16 per H100 SXM, dense
HBM_BW = 3.35e12          # bytes/s per H100 SXM
LINK_BW = 450e9           # bytes/s per direction, NVLink 4

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``models.sharding.STATS``' names -> the reference's HLO names
HLO_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "batch_isend_irecv": "collective-permute",
}


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_op: Dict[str, int]
    count: int


@dataclasses.dataclass
class ModuleCost:
    """One traced step: matmul FLOPs, and bytes and calls per collective
    (HLO names), each rank's."""

    flops: float
    coll_by_op: Dict[str, float]
    coll_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_by_op.values())


@dataclasses.dataclass
class MemoryStats:
    """Live bytes of one traced step, under the names of XLA's
    ``memory_analysis()`` that ``roofline`` reads.  The peak is argument +
    temp: what the step returns is allocated during it, so temp holds it
    (the reference's estimate adds XLA's output and takes off what it
    aliases)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int

    @property
    def peak_bytes(self) -> int:
        return self.argument_size_in_bytes + self.temp_size_in_bytes

    def record(self) -> Dict[str, int]:
        """The reference's four keys."""
        return {"argument_bytes_per_dev": self.argument_size_in_bytes,
                "output_bytes_per_dev": self.output_size_in_bytes,
                "temp_bytes_per_dev": self.temp_size_in_bytes,
                "peak_est_bytes_per_dev": self.peak_bytes}


def collective_stats(mc: ModuleCost) -> CollectiveStats:
    """``mc``'s collectives; ``count`` is the number of calls."""
    return CollectiveStats(
        total_bytes=int(mc.coll_bytes),
        by_op={k: int(v) for k, v in mc.coll_by_op.items()},
        count=int(sum(mc.coll_calls.values())))


# --------------------------------------------------------------------------- #
# the tracer
# --------------------------------------------------------------------------- #

class _Scope:
    """One loop iteration that stands for ``k``; ``lo`` .. ``hi`` are the
    sequence numbers of the autograd nodes created in it, ``weight`` how
    many times each of its ops counts."""

    __slots__ = ("weight", "parent", "lo", "hi", "live0", "peak0", "allocs")

    def __init__(self, k: int, parent: Optional["_Scope"], lo: int,
                 live0: int, peak0: int):
        self.parent, self.lo = parent, lo
        self.weight = k * (parent.weight if parent is not None else 1)
        self.hi = float("inf")
        self.live0, self.peak0 = live0, peak0
        self.allocs = set()


def _check_storages_preserved() -> None:
    """The tracker follows a storage by its Python object, which must live
    as long as the storage does (this torch keeps one object per storage)."""
    t = torch.empty(1, device="meta")
    gone = []
    weakref.finalize(t.untyped_storage(), gone.append, 1)
    if gone or t.untyped_storage() is not t.untyped_storage():
        raise RuntimeError(f"torch {torch.__version__} does not keep one "
                           f"Python object per storage; the live-byte "
                           f"tracker cannot follow storages")


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class Tracer(TorchDispatchMode):
    """Counts matmul FLOPs and follows live bytes of every op dispatched
    under it; ``loop`` runs a trip-counted loop (``models.tripcount``)."""

    def __init__(self):
        super().__init__()
        _check_storages_preserved()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.records: Dict[int, list] = {}     # key -> [nbytes, groups]
        self.external = set()
        self.stack: List[_Scope] = []
        self.scopes: List[_Scope] = []
        self.los: List[int] = []
        self._node_w: Dict[int, int] = {}
        self._composites: Dict[object, bool] = {}

    # ---- weights -------------------------------------------------------- #

    def weight(self) -> int:
        """How many times the op being dispatched counts: the open loop
        iterations' trip counts in a forward (also the remat's recompute,
        which runs with grad on inside a backward node); in a backward, those
        of the iteration that created the node running it."""
        node = torch._C._current_autograd_node()
        if node is None or torch.is_grad_enabled():
            return self.stack[-1].weight if self.stack else 1
        seq = node._sequence_nr()
        w = self._node_w.get(seq)
        if w is None:
            i = bisect.bisect_right(self.los, seq) - 1
            sc = self.scopes[i] if i >= 0 else None
            while sc is not None and not sc.lo <= seq < sc.hi:
                sc = sc.parent
            w = self._node_w[seq] = sc.weight if sc is not None else 1
        return w

    # ---- loops ---------------------------------------------------------- #

    @contextlib.contextmanager
    def repeat(self, k: int):
        """The block runs once and stands for ``k`` runs alike."""
        parent = self.stack[-1] if self.stack else None
        sc = _Scope(k, parent, torch._C._autograd._get_sequence_nr(),
                    self.live, self.peak)
        self.peak = self.live
        self.stack.append(sc)
        self.scopes.append(sc)
        self.los.append(sc.lo)
        try:
            yield
        finally:
            self.stack.pop()
            sc.hi = torch._C._autograd._get_sequence_nr()
            delta = self.live - sc.live0
            extra = (k - 1) * delta if delta > 0 else 0
            survivors = [key for key in sc.allocs if key in self.records]
            if not survivors:
                extra = 0
            self.peak = max(sc.peak0, self.peak + extra)
            if extra:
                group = [len(survivors), extra]
                for key in survivors:
                    self.records[key][1].append(group)
                self.live += extra
            sc.allocs = None

    def loop(self, n: int, exact: int) -> Iterator[int]:
        yield from range(exact)
        with self.repeat(n - exact):
            yield exact

    def _composite(self, func) -> bool:
        """Whether ``func`` has a composite kernel to decompose into."""
        c = self._composites.get(func)
        if c is None:
            c = self._composites[func] = (
                func is not torch.ops.prim.device.default
                and torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
        return c

    # ---- storages ------------------------------------------------------- #

    def _free(self, key: int) -> None:
        nbytes, groups = self.records.pop(key)
        self.live -= nbytes
        for g in groups:
            g[0] -= 1
            if g[0] == 0:
                self.live -= g[1]

    def _forget(self, key: int) -> None:
        self.external.discard(key)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as allocated now, unless it is known."""
        st = _storage(t)
        if st is None:
            return
        key = st._cdata
        if key in self.records or key in self.external:
            return
        n = st.nbytes()
        self.records[key] = [n, []]
        weakref.finalize(st, self._free, key)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        for sc in self.stack:
            sc.allocs.add(key)

    def _inputs(self, args, kwargs) -> None:
        # a storage first seen as an input was made before the trace
        for t in _tensors((args, kwargs)):
            st = _storage(t)
            if st is None:
                continue
            key = st._cdata
            if key not in self.records and key not in self.external:
                self.external.add(key)
                weakref.finalize(st, self._forget, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        # FlopCounterMode's rule: count what a composite op decomposes into
        if self._composite(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        self._inputs(args, kwargs)
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += self.weight() * formula(*args, **kwargs,
                                                  out_val=out)
        for t in _tensors(out):
            if t.device.type == "meta":
                self.track(t)
            elif t.numel() > 1:
                # torch makes an empty or a scalar tensor for itself here and
                # there (remat's dummy input); anything larger is a step
                # computing for real
                raise ValueError(f"{func} made a {tuple(t.shape)} tensor on "
                                 f"{t.device} in a cost trace, which runs on "
                                 f"meta tensors only")
        return out


@contextlib.contextmanager
def _stats_weighted(weight):
    prev = STATS.weight
    STATS.reset()
    STATS.weight = weight
    try:
        yield
    finally:
        STATS.weight = prev


def analyze_step(step, *args, trip_counts: bool = True
                 ) -> Tuple[ModuleCost, MemoryStats]:
    """Run ``step(*args)`` once on ``meta`` tensors and count it.

    Every tensor in ``args`` (modules' parameters and buffers, nested
    dicts, lists and tuples) must be on ``meta``: a cost trace computes
    nothing, and a tensor elsewhere is an error, not a quiet run.  Returns
    the step's ``ModuleCost`` and its ``MemoryStats``: live bytes at entry
    (``argument``), what the step returns that it did not get
    (``output``), and the peak of live bytes during the step less the entry
    (``temp``).  ``STATS`` is reset before and after.  ``trip_counts=False``
    runs every loop iteration (the trip-counted trace must equal it)."""
    for t in _tensors(args):
        if t.device.type != "meta":
            raise ValueError(f"analyze_step runs on meta tensors only; got a "
                             f"{tuple(t.shape)} tensor on {t.device}")
    tracer = Tracer()
    entry_keys = set()
    for t in _tensors(args):
        tracer.track(t)
        entry_keys.add(t.untyped_storage()._cdata)
    entry = tracer.live
    tracer.peak = entry
    # torch imports its compiler lazily at the first call of some ops; an
    # import inside the trace leaves the caller's frames (and their
    # tensors) in reference cycles that, with the collector off, would
    # stay alive to the end of the step
    import torch._dynamo  # noqa: F401
    gc.collect()
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with _stats_weighted(tracer.weight), \
                tripcount.counting(tracer if trip_counts else None), tracer:
            out = step(*args)
        calls = {HLO_NAMES.get(k, k): int(v) for k, v in STATS.calls.items()}
        by_op = {HLO_NAMES.get(k, k): float(v)
                 for k, v in STATS.bytes.items()}
        out_keys = set()
        for t in _tensors(out):
            st = _storage(t)
            if st is not None and st._cdata not in entry_keys \
                    and st._cdata in tracer.records:
                out_keys.add(st._cdata)
        output = sum(tracer.records[k][0] for k in out_keys)
        peak = tracer.peak
        del out
    finally:
        STATS.reset()
        if gc_on:
            gc.enable()
    cost = ModuleCost(flops=float(tracer.flops), coll_by_op=by_op,
                      coll_calls=calls)
    return cost, MemoryStats(argument_size_in_bytes=entry,
                             output_size_in_bytes=output,
                             temp_size_in_bytes=peak - entry)


# --------------------------------------------------------------------------- #
# the roofline (copied from the reference)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float     # MODEL_FLOPS / (HLO_FLOPs * chips)
    coll_by_op: Dict[str, int]
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(module_cost: "ModuleCost", coll: CollectiveStats, n_chips: int,
             model_flops: float, mem_stats=None,
             xla_cost: Optional[Dict] = None) -> Roofline:
    """Three-term roofline from the trip-aware module analysis.

    compute: dot-FLOPs per device (while bodies x trip count) / peak;
    memory: per-device HBM bytes touched — arguments + outputs + temp buffers
    from the real buffer assignment (a one-pass lower bound on HBM traffic);
    collective: per-device collective operand bytes / per-chip link bw."""
    flops = float(module_cost.flops)
    if mem_stats is not None:
        byt = float(mem_stats.argument_size_in_bytes
                    + mem_stats.output_size_in_bytes
                    + mem_stats.temp_size_in_bytes)
    else:
        byt = float((xla_cost or {}).get("bytes accessed", 0.0))
    compute_s = flops / PEAK_FLOPS
    memory_s = byt / HBM_BW
    coll_s = coll.total_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / max(1.0, flops * n_chips)
    kw = {}
    if mem_stats is not None:
        kw = dict(arg_bytes=mem_stats.argument_size_in_bytes,
                  temp_bytes=mem_stats.temp_size_in_bytes,
                  out_bytes=mem_stats.output_size_in_bytes)
    return Roofline(
        flops_per_dev=flops, bytes_per_dev=byt,
        coll_bytes_per_dev=float(coll.total_bytes),
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        coll_by_op=coll.by_op, **kw)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (fwd only);
    N = active params for MoE.  Enc-dec splits N between the encoder (sees
    B·S source frames) and the decoder (sees B·S/tgt_frac target tokens)."""
    B, S = shape.global_batch, shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    if cfg.family == "encdec":
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
        att = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
            + cfg.n_heads * hd * d
        mlp_p = 2 * d * f
        n_enc = cfg.n_enc_layers * (att + mlp_p)
        n_dec = cfg.n_dec_layers * (2 * att + mlp_p) + 2 * cfg.vocab * d
        if shape.kind == "decode":
            return 2.0 * n_dec * B
        d_src = B * S
        d_tgt = B * S // cfg.tgt_frac
        return mult * (n_enc * d_src + n_dec * d_tgt)
    n = cfg.n_active_params()
    if shape.kind == "decode":
        return 2.0 * n * B
    return mult * n * B * S


__all__ = ["COLLECTIVES", "CollectiveStats", "HBM_BW", "HLO_NAMES",
           "LINK_BW", "MemoryStats", "ModuleCost", "PEAK_FLOPS", "Roofline",
           "Tracer", "analyze_step", "collective_stats", "model_flops_for",
           "roofline"]
