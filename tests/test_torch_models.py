"""The port's model zoo against the reference, on the CPU.

Seeded numpy inputs go through the JAX function and its port; weights are
the reference's, carried across with ``lm_params_from_numpy``.  Per-layer
outputs agree within 1e-5, whole models (logits and caches) within 1e-4,
in f32.  The reference's Pallas kernels are not on this path: its experts,
attention and SSD scan are ``jnp``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch.mesh import make_test_mesh
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.engine import Mesh
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
B, S, WINDOW = 2, 20, 24      # S % 16 != 0: flash and SSD chunks both pad


def cfgs(arch, **changes):
    """The reduced config in both packages (the same dataclass fields)."""
    jc = dataclasses.replace(reduced(get_config(arch)), **changes)
    tc = dataclasses.replace(treduced(tget_config(arch)), **changes)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def close_tree(port, ref, tol):
    """Caches: the same keys, float leaves within ``tol``, integer leaves
    equal."""
    if ref is None:
        assert port is None
        return
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for key in ref:
            close_tree(port[key], ref[key], tol)
        return
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        close(port, ref, tol)


def attn_params(key, cfg):
    jp = jlayers.init_attention(jax.random.PRNGKey(key), cfg)
    tp = tlayers.Attention(cfg, "cpu", torch.float32)
    tp.load_state_dict({k: t(v) for k, v in jp.items()})
    return jp, tp


# =============================================================================
# per layer, within 1e-5
# =============================================================================

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    close(tcommon.rms_norm(t(x), t(scale)),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
    close(tcommon.apply_rope(t(q), t(pos), 10_000.0),
          jcommon.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0),
          LAYER_TOL)


@pytest.mark.parametrize("sq,sk,chunk,causal", [
    (32, 32, 16, True),      # two query and two key chunks
    (20, 20, 16, True),      # padded Sq and Sk
    (20, 20, 8, False),      # a chunk smaller than S, padded keys masked
    (7, 37, 16, False),      # cross-shaped: Sq != Sk
    (12, 12, 64, True),      # one chunk (chunk > S)
])
def test_flash(sq, sk, chunk, causal):
    rng = np.random.default_rng(sq + sk + chunk)
    q = rng.standard_normal((2, sq, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    ref = jlayers._flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, chunk=chunk)
    close(tlayers._flash(t(q), t(k), t(v), causal=causal, chunk=chunk), ref,
          LAYER_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("pos", [5, 8, 11])
def test_attention_prefill_and_decode(kv_quant, pos):
    """Prefill with a cache, then one decode step into a window of 8.  pos
    8 and 11 lie past the window: the write clamps to the last slot, as
    the reference's dynamic_update_slice does."""
    jc, tc = cfgs("codeqwen1.5-7b", kv_quant=kv_quant)
    jp, tp = attn_params(0, jc)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 5, jc.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(5), (B, 5)).astype(np.int32)
    jy, jcache = jlayers.attention(jp, jnp.asarray(x), jnp.asarray(positions),
                                   jc, cache={})
    ty, tcache = tlayers.attention(tp, t(x), t(positions), tc, cache={})
    close(ty, jy, LAYER_TOL)
    close_tree(tcache, jcache, LAYER_TOL)
    # grow to 8 slots, and place the next token at ``pos``
    jcache = jlm.grow_caches(jc, {"attn": jax.tree.map(lambda a: a[None],
                                                        jcache)}, 8)["attn"]
    jcache = {k: (jnp.asarray(pos, jnp.int32) if k == "pos" else v[0])
              for k, v in jcache.items()}
    tcache = {k: (t(v) if k != "pos" else torch.tensor(pos, dtype=torch.int32))
              for k, v in jcache.items()}
    x1 = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    p1 = np.full((B, 1), pos, np.int32)
    jy, jnew = jlayers.attention(jp, jnp.asarray(x1), jnp.asarray(p1), jc,
                                 cache=jcache)
    ty, tnew = tlayers.attention(tp, t(x1), t(p1), tc, cache=tcache)
    close(ty, jy, LAYER_TOL)
    close_tree(tnew, jnew, LAYER_TOL)


def test_cross_attention_decode():
    jc, tc = cfgs("seamless-m4t-medium")
    jp, tp = attn_params(1, jc)
    rng = np.random.default_rng(3)
    src = rng.standard_normal((B, 9, jc.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    pos = np.zeros((B, 1), np.int32)
    _, jcache = jlayers.attention(jp, jnp.asarray(src), jnp.asarray(pos), jc,
                                  cache={}, kv_from=jnp.asarray(src), cross=True)
    _, tcache = tlayers.attention(tp, t(src), t(pos), tc, cache={},
                                  kv_from=t(src), cross=True)
    close_tree(tcache, jcache, LAYER_TOL)
    jy, _ = jlayers.attention(jp, jnp.asarray(x1), jnp.asarray(pos), jc,
                              cache=jcache, cross=True)
    ty, _ = tlayers.attention(tp, t(x1), t(pos), tc, cache=tcache, cross=True)
    close(ty, jy, LAYER_TOL)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "seamless-m4t-medium",
                                  "nemotron-4-15b"])
def test_mlp(arch):
    """swiglu, gelu (tanh form) and squared_relu."""
    jc, tc = cfgs(arch)
    jp = jlayers.init_mlp(jax.random.PRNGKey(2), jc)
    tp = tlayers.MLP(tc, "cpu", torch.float32)
    tp.load_state_dict({k: t(v) for k, v in jp.items()})
    x = np.random.default_rng(4).standard_normal((B, 6, jc.d_model)).astype(
        np.float32)
    close(tlayers.mlp(tp, t(x), tc), jlayers.mlp(jp, jnp.asarray(x), jc),
          LAYER_TOL)


def moe_params(cfg, tcfg):
    jp = jlayers.init_moe(jax.random.PRNGKey(5), cfg)
    tp = tlayers.MoE(tcfg, "cpu", torch.float32)
    tp.load_state_dict({k: t(v) for k, v in _flat(jp).items()})
    return jp, tp


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_route_and_moe_dense(arch):
    """The default capacity factor (C = 24 for 64 choices over 4 experts),
    so overflow goes to the drop bin; deepseek adds a shared expert."""
    jc, tc = cfgs(arch)
    jp, tp = moe_params(jc, tc)
    x = np.random.default_rng(6).standard_normal((4, 8, jc.d_model)).astype(
        np.float32)
    xf = x.reshape(-1, jc.d_model)
    jg, je, jaux = jlayers._route(jp, jnp.asarray(xf), jc)
    tg, te, taux = tlayers._route(tp, t(xf), tc)
    # top-k ties would order differently: the experts must agree exactly
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    close(tg, jg, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)
    jy, jaux = jlayers.moe_dense(jp, jnp.asarray(x), jc)
    ty, taux = tlayers.moe_dense(tp, t(x), tc)
    close(ty, jy, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_a2a_one_shard(arch):
    """The one-shard body against the reference's moe_a2a under a 1x1 mesh;
    more than one model shard needs the experts split over a bound mesh
    (``test_torch_distribution.py`` runs it), and raises without one."""
    jc, tc = cfgs(arch)
    jp, tp = moe_params(jc, tc)
    x = np.random.default_rng(7).standard_normal((4, 1, jc.d_model)).astype(
        np.float32)
    jy, jaux = jlayers.moe_a2a(jp, jnp.asarray(x), jc, make_test_mesh(1, 1))
    ty, taux = tlayers.moe_a2a(tp, t(x), tc, Mesh(1, 1))
    close(ty, jy, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)
    with pytest.raises(ValueError):
        tlayers.moe_a2a(tp, t(x), tc, Mesh(2, 1))


def ssm_params(cfg, tcfg, seed=8):
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    # the init's zeros/ones would hide dt_bias, A_log, D and the conv bias
    for name in ("conv_bias", "dt_bias", "A_log", "D", "norm"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * 0.3 + (
            1.0 if name in ("D", "norm") else 0.0), jnp.float32)
    tp = tssm.SSM(tcfg, "cpu", torch.float32)
    tp.load_state_dict({k: t(v) for k, v in jp.items()})
    return jp, tp


def test_causal_conv():
    rng = np.random.default_rng(9)
    xbc = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    close(tssm._causal_conv(t(xbc), t(w), t(b)),
          jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b)),
          LAYER_TOL)


@pytest.mark.parametrize("seq,with_h0", [(37, True), (37, False), (32, True),
                                         (5, True)])
def test_ssd_chunked(seq, with_h0):
    """Q = 16: 37 pads three chunks with dt = 0 steps, 32 needs none, 5 is
    one short chunk; a non-zero h0 carries into the first chunk."""
    jc, tc = cfgs("mamba2-1.3b")
    H, P, N = jc.ssm_heads, jc.ssm_headdim, jc.ssm_state
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((B, seq, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, seq, H)))).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, seq, N)).astype(np.float32)
    Cm = rng.standard_normal((B, seq, N)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A_log, Bm, Cm)), jc,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(t, (x, dt, A_log, Bm, Cm)), tc,
                              h0=None if h0 is None else t(h0))
    close(ty, jy, LAYER_TOL)
    close(th, jh, LAYER_TOL)


def test_ssm_block_full_and_decode():
    jc, tc = cfgs("mamba2-1.3b")
    jp, tp = ssm_params(jc, tc)
    rng = np.random.default_rng(10)
    u = rng.standard_normal((B, 19, jc.d_model)).astype(np.float32)
    jcache0 = jssm.make_ssm_cache(jc, B, jnp.float32)
    jy, jcache = jssm.ssm_block(jp, jnp.asarray(u), jc, cache=jcache0)
    ty, tcache = tssm.ssm_block(tp, t(u), tc,
                                cache=tssm.make_ssm_cache(tc, B, torch.float32,
                                                          "cpu"))
    close(ty, jy, LAYER_TOL)
    close_tree(tcache, jcache, LAYER_TOL)
    u1 = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    jy, jnew = jssm.ssm_block(jp, jnp.asarray(u1), jc, cache=jcache)
    ty, tnew = tssm.ssm_block(tp, t(u1), tc,
                              cache={k: t(v) for k, v in jcache.items()})
    close(ty, jy, LAYER_TOL)
    close_tree(tnew, jnew, LAYER_TOL)


def test_short_prompt_conv_tail_matches_reference():
    """A 2-token prompt leaves a conv tail of 2 rows (< Kw - 1 = 3) in both
    packages, and the decode step after it fails in both."""
    jc, tc = cfgs("mamba2-1.3b")
    jp, tp = ssm_params(jc, tc)
    u = np.random.default_rng(11).standard_normal((B, 2, jc.d_model)).astype(
        np.float32)
    jtail = jssm.xbc_tail(jnp.asarray(u), jp, jc, jc.ssm_conv)
    ttail = tssm.xbc_tail(t(u), tp, tc, tc.ssm_conv)
    assert ttail.shape == jtail.shape == (B, 2, jc.d_inner + 2 * jc.ssm_state)
    close(ttail, jtail, LAYER_TOL)
    cache = {"conv": jtail, "state": jnp.zeros((B, jc.ssm_heads,
                                                jc.ssm_headdim, jc.ssm_state))}
    u1 = u[:, :1]
    with pytest.raises(ValueError):
        jssm.ssm_block(jp, jnp.asarray(u1), jc, cache=cache)
    with pytest.raises(RuntimeError):
        tssm.ssm_block(tp, t(u1), tc, cache={k: t(v) for k, v in cache.items()})


# =============================================================================
# whole models (every architecture: tests/test_torch_lm_serve.py)
# =============================================================================

def models(arch, seed=0, **changes):
    """Reduced configs, the reference's f32 init at ``seed`` and the port's
    module holding its weights."""
    jc, tc = cfgs(arch, **changes)
    mod = jencdec if jc.family == "encdec" else jlm
    jp = mod.init(jax.random.PRNGKey(seed), jc, dtype=jnp.float32)
    return jc, tc, jp, lm_params_from_numpy(tc, np_tree(jp), device="cpu")


def count(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_make_caches_match_reference(arch):
    jc, tc = cfgs(arch)
    close_tree(tlm.make_caches(tc, B, WINDOW, torch.float32, "cpu"),
               jlm.make_caches(jc, B, WINDOW, jnp.float32), 0.0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b",
                                  "codeqwen1.5-7b", "granite-moe-1b-a400m"])
def test_prefill_then_decode_matches_full_forward(arch):
    """The reference's own consistency test (tests/test_models.py), on the
    port: prefill logits equal the full forward's last position, and one
    decode step equals the forward on S + 1 tokens, within 5e-3.  MoE
    archs use a no-drop capacity factor, as there."""
    cfg = treduced(tget_config(arch))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    p = tlm.init(torch.Generator().manual_seed(1), cfg, dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 32)))
    W = tlm.unembed_matrix(p)
    full = tlm.forward(p, cfg, tokens=toks)[0][:, -1] @ W
    logits, caches = tlm.prefill(p, cfg, tokens=toks)
    torch.testing.assert_close(logits, full, rtol=5e-3, atol=5e-3)
    nxt = logits.argmax(-1)[:, None]
    caches = tlm.grow_caches(cfg, caches, 36)
    logits, _ = tlm.decode_step(p, cfg, nxt, caches, mesh=Mesh(1, 1))
    full = tlm.forward(p, cfg, tokens=torch.cat([toks, nxt], 1))[0][:, -1] @ W
    torch.testing.assert_close(logits, full, rtol=5e-3, atol=5e-3)
