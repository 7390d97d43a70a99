"""Train / prefill / serve step factories (port of ``repro.launch.steps``).

``CapturedServeStep`` is the port's counterpart of ``jax.jit`` around
``make_serve_step`` on one card: the decode step, with its caches written
in place (``lm.decode_step_``), captured once per shape in a CUDA graph and
replayed once per generated token.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

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
