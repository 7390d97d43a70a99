"""Train / prefill / serve step factories (port of ``repro.launch.steps``,
one device)."""

from __future__ import annotations

from typing import Dict

import torch

from ..models import encdec, lm
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw_update


def _model(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


def one_device(mesh, what: str = "this step") -> None:
    """Raise unless ``mesh`` (anything with ``model`` and ``data`` axis
    sizes, or None) is a single device: the data and model axes are not
    ported."""
    if mesh is not None and (getattr(mesh, "model", 1) != 1
                             or getattr(mesh, "data", 1) != 1):
        raise NotImplementedError(
            f"{what} runs on one device; a mesh with model > 1 or data > 1 "
            f"(got model={getattr(mesh, 'model', 1)}, "
            f"data={getattr(mesh, 'data', 1)}) is not ported")


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh=None,
                    grad_specs=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})`` on one device.

    ``params`` is the model (an ``lm.LM`` or ``encdec.EncDec`` whose
    parameters require grad); the step writes the new parameters into it
    under ``torch.no_grad()`` and returns it.  ``mesh`` goes to the loss as
    in the reference (a 1x1 mesh makes ``moe_impl="a2a"`` configs take the
    one-shard expert-parallel body).  The batch splits into up to
    ``cfg.microbatch`` microbatches along its first axis, clamped as the
    reference clamps them; their gradients are summed in f32 and averaged.
    ``grad_specs`` (the reference's ZeRO-2 gradient sharding over a data
    axis) must be None."""
    one_device(mesh, "make_train_step")
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs shards gradients over a data axis; one device only")
    mod = _model(cfg)

    def grads_of(params, plist, batch):
        lval, _ = mod.loss_fn(params, cfg, batch, mesh)
        gs = torch.autograd.grad(lval, plist, allow_unused=True)
        return lval.detach(), [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if g is None else g.float() for g, p in zip(gs, plist)]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        # the reference's clamp, with one data rank: n_micro divides B
        B = batch[min(batch)].shape[0]
        n_micro = max(1, min(cfg.microbatch, B))
        while n_micro > 1 and B % n_micro:
            n_micro -= 1
        named = dict(params.named_parameters())
        names, plist = list(named), list(named.values())
        if n_micro > 1:
            mb = B // n_micro
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
        new_params, new_opt, om = adamw_update(dict(zip(names, grads)),
                                               opt_state, named, opt_cfg)
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
