"""The port's training path against the reference, on the CPU, in f32.

Weights are the reference's, carried across with ``lm_params_from_numpy``;
inputs come from seeded numpy.  The reference runs through its own jitted
``loss_fn`` and ``value_and_grad`` (its ``make_train_step`` in
``test_torch_train_step.py``, which shares these helpers).  Tolerances:
the loss within 1e-5 and every gradient leaf within 1e-4; ``adamw_update``
fed the reference's own gradients within 1e-6; remat on against remat off
bit-equal.  The training path reaches no Pallas kernel: the experts,
attention and SSD scan are ``jnp``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    named_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.engine import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.optim import OptConfig
from repro_torch.optim import adamw as tadamw

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
METRIC_TOL, MOMENT_TOL, ADAMW_TOL = 1e-5, 1e-4, 1e-6
B, S = 2, 20                  # S % 16 != 0: flash and SSD chunks both pad
# one arch per family, and internvl2's vision-stub ``embeds`` batches
FAMILIES = ["granite-moe-1b-a400m", "codeqwen1.5-7b", "mamba2-1.3b",
            "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def cfgs(arch, **changes):
    jc = dataclasses.replace(reduced(get_config(arch)), **changes)
    tc = dataclasses.replace(treduced(tget_config(arch)), **changes)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def models(arch, seed=0, **changes):
    """Reduced configs, the reference's f32 init and the port's trainable
    module holding its weights."""
    jc, tc = cfgs(arch, **changes)
    mod = jencdec if jc.family == "encdec" else jlm
    jp = mod.init(jax.random.PRNGKey(seed), jc, dtype=jnp.float32)
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp.requires_grad_(True)


def batch(cfg, seed=0, b=B, s=S):
    """Seeded numpy inputs in the family's batch layout."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    if cfg.family == "encdec":
        return {"src_embeds": (rng.standard_normal((b, s, cfg.d_model))
                               * 0.05).astype(np.float32),
                "tgt_tokens": toks[:, :s // 2], "labels": toks[:, 1:s // 2 + 1]}
    if cfg.modality == "vision_stub":
        return {"embeds": (rng.standard_normal((b, s, cfg.d_model))
                           * 0.05).astype(np.float32), "labels": toks[:, 1:]}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def close(port, ref, tol, atol=None):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol if atol is None else atol)


def close_tree(port, ref, tol, atol=None):
    """Same paths and shapes, leaves within ``tol``."""
    pl = jax.tree_util.tree_flatten_with_path(port)[0]
    rl = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [jax.tree_util.keystr(p) for p, _ in pl] == \
        [jax.tree_util.keystr(p) for p, _ in rl]
    for (path, a), (_, b) in zip(pl, rl):
        assert np.shape(a) == np.shape(b), jax.tree_util.keystr(path)
        close(a, b, tol, atol)


def port_grads(tc, tp, b, mesh=None):
    named = dict(tp.named_parameters())
    mod = tencdec if tc.family == "encdec" else tlm
    loss, _ = mod.loss_fn(tp, tc, tbatch(b), mesh)
    # the vision stub never reads ``embed``: its gradient is zero, as JAX's
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, named.values())]
    return float(loss.detach()), named_to_numpy(dict(zip(named, grads)))


@functools.lru_cache(maxsize=None)
def ref_grads(arch, remat=False):
    """The reference's loss and gradients on ``models(arch)``'s weights and
    ``batch``'s inputs (computed once per arch: compiling is what costs)."""
    jc, _, jp, _ = models(arch, remat=remat)
    mod = jencdec if jc.family == "encdec" else jlm
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: mod.loss_fn(p, jc, bb), has_aux=True))(
            jp, jbatch(batch(jc)))
    return float(loss), jax.tree.map(np.asarray, grads)


# =============================================================================
# the loss and its gradients
# =============================================================================

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads(arch):
    jc, tc, jp, tp = models(arch)
    t_loss, t_grads = port_grads(tc, tp, batch(jc))
    j_loss, j_grads = ref_grads(arch)
    close(t_loss, j_loss, LOSS_TOL)
    close_tree(t_grads, j_grads, GRAD_TOL)


def test_lm_loss_from_h_matches_reference():
    """The loss alone, as written: logsumexp minus the label's logit from
    its unembedding row, untied and tied."""
    for arch in ("codeqwen1.5-7b", "granite-moe-1b-a400m"):
        jc, tc, jp, tp = models(arch)
        rng = np.random.default_rng(3)
        h = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
        labels = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
        close(float(tlm.lm_loss_from_h(tp, tc, torch.from_numpy(h),
                                       torch.from_numpy(labels)).detach()),
              jlm.lm_loss_from_h(jp, jc, jnp.asarray(h), jnp.asarray(labels)),
              LOSS_TOL)


# =============================================================================
# remat
# =============================================================================

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_remat_on_equals_remat_off(arch):
    """``torch.utils.checkpoint`` recomputes each unit (MoE routing, the
    hybrid's group and tail, encoder and decoder layers): the same loss and
    gradients, bit for bit on the CPU, and the reference with remat on
    agrees."""
    jc, tc, jp, tp = models(arch, remat=True)
    b = batch(jc)
    on_loss, on_grads = port_grads(tc, tp, b)
    off_loss, off_grads = port_grads(dataclasses.replace(tc, remat=False),
                                     tp, b)
    assert on_loss == off_loss
    close_tree(on_grads, off_grads, 0.0)
    j_loss, j_grads = ref_grads(arch, remat=True)
    close(on_loss, j_loss, LOSS_TOL)
    close_tree(on_grads, j_grads, GRAD_TOL)


def test_remat_recomputes_in_backward():
    """With remat on, the blocks' activations are not kept: the backward
    runs each block's forward again."""
    jc, tc, _, tp = models("codeqwen1.5-7b", remat=True)
    calls = {"n": 0}
    orig = tlm._dense_block

    def counted(*args, **kw):
        calls["n"] += 1
        return orig(*args, **kw)

    tlm._dense_block = counted
    try:
        port_grads(tc, tp, batch(jc))
        with_remat = calls["n"]
        calls["n"] = 0
        port_grads(dataclasses.replace(tc, remat=False), tp, batch(jc))
    finally:
        tlm._dense_block = orig
    assert (with_remat, calls["n"]) == (2 * tc.n_layers, tc.n_layers)


# =============================================================================
# the optimizer alone
# =============================================================================

def _state(tree, rng, step):
    leaves, treedef = jax.tree.flatten(tree)
    draw = [[rng.standard_normal(np.shape(x)).astype(np.float32) * s
             for x in leaves] for s in (1.0, 0.01, 1e-4)]
    nu = [np.abs(x) for x in draw[2]]
    return {"master": treedef.unflatten(draw[0]),
            "mu": treedef.unflatten(draw[1]),
            "nu": treedef.unflatten(nu),
            "step": np.asarray(step, np.int32)}


@pytest.mark.parametrize("grad_scale,clips", [(1e-3, False), (10.0, True)])
def test_adamw_update_on_reference_grads(grad_scale, clips):
    """The reference's own gradients (scaled so that clipping does or does
    not trigger) and one state: new params, moments and master within
    1e-6."""
    jc, tc, jp, tp = models("granite-moe-1b-a400m")
    _, grads = ref_grads("granite-moe-1b-a400m")
    grads = jax.tree.map(lambda g: g * grad_scale, grads)
    state = _state(grads, np.random.default_rng(4), step=5)
    cfg = dict(lr=1e-3, warmup_steps=3, total_steps=20)
    jnew, jstate, jm = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jp, JOptConfig(**cfg))
    assert (float(jm["grad_norm"]) > 1.0) == clips
    tstate = opt_state_from_numpy(state, device="cpu")
    tgrads = opt_state_from_numpy({"master": grads, "mu": grads, "nu": grads,
                                   "step": 0}, device="cpu")["master"]
    tnew, tstate, tm = tadamw.adamw_update(
        tgrads, tstate, dict(tp.named_parameters()), OptConfig(**cfg))
    close(float(tm["grad_norm"]), jm["grad_norm"], ADAMW_TOL)
    close(float(tm["lr"]), jm["lr"], ADAMW_TOL)
    out = opt_state_to_numpy(tstate)
    assert int(out["step"]) == int(jstate["step"]) == 6
    for key in ("master", "mu", "nu"):
        close_tree(out[key], jax.tree.map(np.asarray, jstate[key]), ADAMW_TOL)
    close_tree(named_to_numpy(tnew), jax.tree.map(np.asarray, jnew), ADAMW_TOL)


def test_global_norm_of_a_large_leaf():
    """The gradient norm of a 4M-element leaf (granite-moe-1b-a400m's
    experts hold 50M) within 1e-6 of the float64 norm and of the
    reference's; ``torch.linalg.vector_norm`` on the CPU is 8e-5 off."""
    g = np.random.default_rng(0).standard_normal(4_000_000).astype(np.float32)
    exact = float(np.sqrt(np.sum(g.astype(np.float64) ** 2)))
    port = float(tadamw.global_norm([torch.from_numpy(g), torch.ones(3)]))
    close(port, np.sqrt(exact ** 2 + 3), ADAMW_TOL)
    close(port, jadamw.global_norm([jnp.asarray(g), jnp.ones(3)]), ADAMW_TOL)


def test_schedule_matches_reference():
    """Step 0, the end of warmup, the first step after it, midway through
    the cosine and the end."""
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    for step in (0, 9, 10, 60, 110, 200):
        close(float(tadamw.schedule(torch.tensor(step, dtype=torch.int32),
                                    OptConfig(**cfg))),
              jadamw.schedule(jnp.asarray(step, jnp.int32), JOptConfig(**cfg)),
              ADAMW_TOL)


def test_opt_state_round_trip():
    jc, tc, jp, tp = models("zamba2-1.2b")
    state = tadamw.adamw_init(tp)
    ref = jadamw.adamw_init(jp)
    as_ref = opt_state_to_numpy(state)
    close_tree(as_ref, jax.tree.map(np.asarray, ref), 0.0)
    back = opt_state_from_numpy(as_ref, device="cpu")
    assert set(back["master"]) == set(state["master"])
    for key in ("master", "mu", "nu"):
        for name, val in state[key].items():
            assert torch.equal(back[key][name], val), (key, name)


def test_params_to_numpy_inverts_from_numpy():
    """``lm_params_to_numpy`` stacks the layers back, for every family
    layout (``shared_attn``, ``enc_layers`` / ``dec_layers``)."""
    for arch in ("zamba2-1.2b", "seamless-m4t-medium", "granite-moe-1b-a400m"):
        _, _, jp, tp = models(arch)
        close_tree(lm_params_to_numpy(tp), jax.tree.map(np.asarray, jp), 0.0)


def test_one_device_only():
    """A step in one process is a one-device step: a mesh of several slots
    runs one process per slot, so an unbound one raises (the 2x2 step is
    ``test_torch_distribution.py``'s); without a mesh ``grad_specs`` shards
    nothing, as in the reference."""
    _, tc, _, _ = models("codeqwen1.5-7b")
    for mesh in (Mesh(2, 1), Mesh(1, 2)):
        with pytest.raises(ValueError, match="bind"):
            make_train_step(tc, OptConfig(), mesh)
    assert callable(make_train_step(tc, OptConfig(), None, grad_specs={}))
