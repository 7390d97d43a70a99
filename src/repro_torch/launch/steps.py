"""Train / prefill / serve step factories (port of ``repro.launch.steps``).

``CapturedServeStep`` is the port's counterpart of ``jax.jit`` around
``make_serve_step`` on one card: the decode step, with its caches written
in place (``lm.decode_step_``), captured once per shape in a CUDA graph and
replayed once per generated token.  ``CapturedTrainStep`` is the same for
``make_train_step``: the whole one-device train step (forward, backward,
clip, schedule and the fused AdamW pass, every state tensor written in
place) captured once per batch signature and replayed once per step.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from ..kernels import adamw as fused_adamw
from ..models import encdec, lm, tripcount
from ..models.config import ModelConfig
from ..models.sharding import reduce_
from ..optim import OptConfig, adamw_init, adamw_update
from . import partition, specs
from .mesh import as_mesh, dp_axes, dp_size


def _model(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh=None,
                    grad_specs=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``.

    ``params`` is the model (an ``lm.LM`` or ``encdec.EncDec`` whose
    parameters require grad); the step writes the new parameters into it
    under ``torch.no_grad()`` and returns it.  ``mesh`` goes to the loss as
    in the reference (a 1x1 mesh makes ``moe_impl="a2a"`` configs take the
    one-shard expert-parallel body; the engine's ``Mesh(model, data)`` reads
    as the same mesh).  The batch splits into up to ``cfg.microbatch``
    microbatches along its first axis, clamped as the reference clamps
    them; their gradients are summed in f32 and averaged.

    On a bound mesh of more than one rank, each rank holds its slices
    (``launch.partition``): ``params`` split over ``model``, ``opt_state``
    the ZeRO slices of ``opt_specs``, and ``batch`` this data rank's rows.
    The gradients are averaged over the data axes: all-reduced and cut to
    the ZeRO slice, or, with ``grad_specs`` (the master's ``opt_specs``,
    as the reference passes them), reduce-scattered to it (ZeRO-2).  The
    loss returned is the mean over the global batch."""
    mesh = as_mesh(mesh)
    mod = _model(cfg)
    sharded = mesh is not None and mesh.size > 1
    dp_sz = dp_size(mesh) if mesh is not None else 1
    if sharded:
        if not mesh.bound:
            raise ValueError(f"a train step on {mesh} runs one process per "
                             f"mesh slot: bind the mesh (DeviceMesh.bind)")
        shape = specs.params_shape(cfg)
        o_specs = partition.opt_specs(
            mesh, adamw_init(shape), partition.params_specs(mesh, shape))
        o_specs = o_specs["master"]
        if grad_specs is not None and dict(grad_specs) != o_specs:
            raise ValueError("grad_specs must be the optimizer state's "
                             "master specs (opt_specs(...)['master'])")
        dpa = [a for a in dp_axes(mesh) if mesh.axis_size(a) > 1]

    def grads_of(params, plist, batch):
        lval, _ = mod.loss_fn(params, cfg, batch, mesh)
        gs = torch.autograd.grad(lval, plist, allow_unused=True)
        return lval.detach(), [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if g is None else g.float() for g, p in zip(gs, plist)]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        # the reference's clamp: B/n_micro rows must still split over dp
        B = batch[min(batch)].shape[0] * dp_sz
        n_micro = max(1, min(cfg.microbatch, B // max(1, dp_sz)))
        while n_micro > 1 and (B % n_micro or (B // n_micro) % dp_sz):
            n_micro -= 1
        named = dict(params.named_parameters())
        names, plist = list(named), list(named.values())
        if n_micro > 1:
            mb = B // dp_sz // n_micro
            acc, losses = None, []
            # the first microbatch's gradients are the accumulator itself
            for i in tripcount.trips(n_micro, exact=2):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                lval, g = grads_of(params, plist, micro)
                acc = g if acc is None else torch._foreach_add(acc, g)
                losses.append(lval)
            grads = torch._foreach_div(acc, n_micro)
            lval = torch.stack(tripcount.full(losses, n_micro, exact=2)).mean()
        else:
            lval, grads = grads_of(params, plist, batch)
        grads = dict(zip(names, grads))
        if sharded:
            grads = partition.reduce_named(grads, o_specs, mesh, dpa,
                                           scatter=grad_specs is not None)
            grads = {n: g / dp_sz for n, g in grads.items()}
            for a in dpa:
                lval = reduce_(lval, mesh, a)
            lval = lval / dp_sz
        new_params, new_opt, om = adamw_update(
            grads, opt_state, named, opt_cfg,
            mesh if sharded else None, o_specs if sharded else None)
        del grads
        with torch.no_grad():
            torch._foreach_copy_(plist, [new_params[n] for n in names])
        return params, new_opt, {"loss": lval, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch) -> (last-position logits, caches)``
    (encdec: the encoder output in place of caches).  On a mesh the caches
    come back in ``partition.cache_specs``' layout (``lm.prefill``), as the
    reference's ``out_shardings`` give them."""

    def prefill_step(params, batch):
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, cfg, batch["src_embeds"],
                                    mesh=mesh)
            h = encdec.decode_train(params, cfg, enc_out, batch["tgt_tokens"],
                                    mesh=mesh)
            return lm._logits(params, h[:, -1], mesh), enc_out
        return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One decode step: greedy next token [B, 1] (int32) + updated caches."""

    def serve_step(params, caches, tokens):
        if cfg.family == "encdec":
            logits, new_caches = encdec.decode_step(params, cfg, tokens, caches,
                                                    mesh=mesh)
        else:
            logits, new_caches = lm.decode_step(params, cfg, tokens, caches,
                                                mesh=mesh)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, new_caches

    return serve_step


#: eager steps a new graph's buffers run on a side stream before capture
#: (kernel selection and the allocator settle there, not in the graph)
_WARMUP = 2


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested cache dict, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _empty_like(tree):
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return None if tree is None else torch.empty_like(tree)


class _Graph:
    """One captured decode step: its static token, cache and logits
    buffers and the graph that reads and writes them."""

    def __init__(self, tokens, caches):
        self.tokens = torch.empty_like(tokens)
        self.caches = _empty_like(caches)
        self.logits = None
        self.graph = None

    def load(self, caches, tokens) -> None:
        for dst, src in zip(_leaves(self.caches), _leaves(caches)):
            dst.copy_(src)
        self.tokens.copy_(tokens)


class CapturedServeStep:
    """The decode step of ``make_serve_step`` on one CUDA device as CUDA
    graphs: the counterpart of the reference's ``jax.jit(make_serve_step(
    cfg, mesh))``.

    A graph holds "the in-place decode step (``lm.decode_step_`` /
    ``encdec.decode_step_``), then the greedy token written into the static
    token buffer", so each replay reads the token the one before wrote.
    One graph per shape of (tokens, caches) — in the serve loop, per batch
    size and window, as ``jit`` retraces per shape; a queue's last, short
    batch gets its own.  A new shape allocates static buffers, copies the
    caches in, warms up on a side stream (the warm-up's writes are
    overwritten) and captures; ``capture_s`` records each capture's
    seconds (warm-up included).  A call copies the prefill's caches into
    the static buffers once and replays the graph ``steps`` times.  The
    step syncs nothing with the host: ``pos`` lives on the device.  A
    capture that fails raises: there is no eager retry.

    ``replays`` and ``captures`` count graph replays and captures in the
    whole process (``reset_counts`` zeroes them)."""

    replays = 0
    captures = 0

    def __init__(self, cfg: ModelConfig, params, mesh=None):
        self.cfg, self.params, self.mesh = cfg, params, mesh
        self.graphs: Dict[Tuple, _Graph] = {}
        self.capture_s: List[float] = []
        self.step_logits: List[torch.Tensor] = []

    @classmethod
    def reset_counts(cls) -> None:
        cls.replays = 0
        cls.captures = 0

    def _step(self, g: _Graph) -> torch.Tensor:
        mod = _model(self.cfg)
        logits = mod.decode_step_(self.params, self.cfg, g.tokens, g.caches,
                                  mesh=self.mesh)
        g.tokens.copy_(torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
        return logits

    def _capture(self, caches, tokens) -> _Graph:
        t0 = time.perf_counter()
        g = _Graph(tokens, caches)
        g.load(caches, tokens)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self._step(g)
        torch.cuda.current_stream().wait_stream(side)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph):
            g.logits = self._step(g)
        torch.cuda.synchronize()
        self.capture_s.append(time.perf_counter() - t0)
        CapturedServeStep.captures += 1
        return g

    def __call__(self, caches, tokens, steps: int,
                 keep_logits: bool = False) -> List[torch.Tensor]:
        """``steps`` greedy tokens ([B, 1] int32 each, on the device) after
        ``tokens`` from the prefill's ``caches`` (which stay as they are);
        with ``keep_logits``, each step's logits are kept in
        ``step_logits``."""
        self.step_logits = []
        if steps <= 0:
            return []
        key = tuple((tuple(t.shape), t.dtype)
                    for t in [tokens] + _leaves(caches))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(caches, tokens)
        g.load(caches, tokens)
        out = []
        for _ in range(steps):
            g.graph.replay()
            CapturedServeStep.replays += 1
            out.append(g.tokens.clone())
            if keep_logits:
                self.step_logits.append(g.logits.clone())
        return out


def _state_ptrs(params, opt_state) -> List[int]:
    """The ``data_ptr`` of every parameter and optimizer-state tensor, in a
    fixed order."""
    ptrs = [p.data_ptr() for p in params.parameters()]
    for key in ("master", "mu", "nu"):
        ptrs += [opt_state[key][n].data_ptr() for n in sorted(opt_state[key])]
    return ptrs + [opt_state["step"].data_ptr()]


class _TrainGraph:
    """One captured train step: its static batch buffers, the metrics its
    capture left in the graph's pool, the fused AdamW launches it holds and
    the addresses of the state it reads and writes."""

    def __init__(self, batch: Dict[str, torch.Tensor]):
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.metrics: Dict[str, torch.Tensor] = {}
        self.adamw = None
        self.graph = None
        self.state_ptrs: List[int] = []

    def load(self, batch: Dict[str, torch.Tensor]) -> None:
        for k, v in batch.items():
            self.batch[k].copy_(v)


class CapturedTrainStep:
    """The train step of ``make_train_step`` on one CUDA device as CUDA
    graphs: the counterpart of the reference's ``jax.jit(make_train_step(
    cfg, opt_cfg, mesh), donate_argnums=(0, 1))``.

    A graph holds the whole step on its static batch buffers: the loss
    forward (remat units under ``torch.utils.checkpoint``), the gradients
    with the remat recompute, the microbatches, the clip, the schedule,
    one fused AdamW launch per group, the new parameters written into the
    model and the step counter incremented, all in place; ``loss``,
    ``grad_norm`` and ``lr`` stay in the graph's pool.  One graph per batch
    signature (each key's shape and dtype), as ``jit`` retraces per shape.
    The first call with a new signature runs one real step eagerly on a
    side stream as the warm-up (kernel selection, the cuBLAS workspaces
    and the autograd threads settle in it; a step of the run, whose result
    is returned), then captures, which runs nothing; ``capture_s`` records
    each such call's seconds.  Later calls copy the batch into the buffers, replay,
    and return ``(params, opt_state, metrics)``: the very objects given,
    and the metrics cloned out of the graph.

    The graph reads and writes the state it was captured on, so every call
    must hand it the same tensors (a checkpoint restores into them in
    place); a call with others raises.  A capture that fails raises, and so
    does every later call: there is no eager retry.  ``replays`` and
    ``captures`` count in the whole process (``reset_counts`` zeroes
    them)."""

    replays = 0
    captures = 0

    def __init__(self, cfg: ModelConfig, opt_cfg: OptConfig, mesh=None):
        mesh = as_mesh(mesh)
        if mesh is not None and mesh.size > 1:
            raise ValueError(f"CapturedTrainStep runs on one device; the "
                             f"step on {mesh} stays eager")
        self.step = make_train_step(cfg, opt_cfg, mesh)
        self.graphs: Dict[Tuple, _TrainGraph] = {}
        self.capture_s: List[float] = []
        self.failed = None

    @classmethod
    def reset_counts(cls) -> None:
        cls.replays = 0
        cls.captures = 0

    def buffers(self, batch: Dict[str, torch.Tensor]) -> _TrainGraph:
        """The static buffers of ``batch``'s signature, holding it (no
        graph yet)."""
        g = _TrainGraph(batch)
        g.load(batch)
        return g

    def body(self, params, opt_state, g: _TrainGraph):
        """What the graph captures: the train step on ``g``'s batch
        buffers."""
        return self.step(params, opt_state, g.batch)

    def _capture(self, params, opt_state, g: _TrainGraph) -> None:
        torch.cuda.empty_cache()
        # a table row per parameter covers every group's launch
        plist = list(params.parameters())
        g.adamw = fused_adamw.CapturedLaunches(len(plist), plist[0].device)
        g.graph = torch.cuda.CUDAGraph()
        with fused_adamw.capturing(g.adamw), torch.cuda.graph(g.graph):
            _, _, g.metrics = self.body(params, opt_state, g)
        g.adamw.upload()
        torch.cuda.synchronize()

    def _first(self, params, opt_state, batch):
        t0 = time.perf_counter()
        g = self.buffers(batch)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _, _, metrics = self.body(params, opt_state, g)
        torch.cuda.current_stream().wait_stream(side)
        metrics = {k: v.clone() for k, v in metrics.items()}
        try:
            self._capture(params, opt_state, g)
        except Exception as e:
            self.failed = e
            raise
        g.state_ptrs = _state_ptrs(params, opt_state)
        self.capture_s.append(time.perf_counter() - t0)
        CapturedTrainStep.captures += 1
        return g, metrics

    def __call__(self, params, opt_state, batch: Dict[str, torch.Tensor]):
        if self.failed is not None:
            raise RuntimeError("the train step's CUDA graph capture failed "
                               "earlier") from self.failed
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        g = self.graphs.get(key)
        if g is None:
            g, metrics = self._first(params, opt_state, batch)
            self.graphs[key] = g
            return params, opt_state, metrics
        if _state_ptrs(params, opt_state) != g.state_ptrs:
            raise RuntimeError("CapturedTrainStep: the parameters or "
                               "optimizer state are not the tensors the "
                               "graph was captured on (restore into them in "
                               "place)")
        g.load(batch)
        g.graph.replay()
        g.adamw.replayed()
        CapturedTrainStep.replays += 1
        return params, opt_state, {k: v.clone() for k, v in g.metrics.items()}
