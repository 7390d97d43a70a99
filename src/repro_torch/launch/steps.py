"""Train / prefill / serve step factories (port of ``repro.launch.steps``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models import encdec, lm
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
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                lval, g = grads_of(params, plist, micro)
                acc = g if acc is None else torch._foreach_add(acc, g)
                losses.append(lval)
            grads = torch._foreach_div(acc, n_micro)
            lval = torch.stack(losses).mean()
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
    def prefill_step(params, batch):
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, cfg, batch["src_embeds"])
            h = encdec.decode_train(params, cfg, enc_out, batch["tgt_tokens"])
            logits = torch.matmul(h[:, -1].float(),
                                  encdec.unembed_matrix(params).float())
            return logits, enc_out
        return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One decode step: greedy next token [B, 1] (int32) + updated caches."""

    def serve_step(params, caches, tokens):
        if cfg.family == "encdec":
            logits, new_caches = encdec.decode_step(params, cfg, tokens, caches)
        else:
            logits, new_caches = lm.decode_step(params, cfg, tokens, caches,
                                                mesh=mesh)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, new_caches

    return serve_step
