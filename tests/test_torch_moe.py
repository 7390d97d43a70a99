"""The grouped expert FFN: the port's ``moe_ffn`` against the reference's
Pallas kernel (interpret mode) and the ``moe_gemm_ref`` oracles, on the CPU.

Tolerances (error = max |a - b| / (1 + |b|)), as the reference's own kernel
tests: f32 1e-4 (both sides accumulate in f32, in other orders); bf16 5e-2
(the hidden tile is rounded to bf16 on both sides, and the output once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_ffn import moe_ffn as jax_moe_ffn
from repro.kernels.ref import moe_gemm_ref as jax_moe_gemm_ref
from repro_torch.kernels import moe_ffn as M
from repro_torch.kernels.ref import moe_gemm_ref

TOL = {"f32": 1e-4, "bf16": 5e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# the reference's MOE_CASES (tests/test_kernels.py): E, C, d, f, f_tile
MOE_CASES = [
    (4, 16, 64, 256, 64, "f32"),
    (2, 32, 128, 512, 128, "f32"),
    (8, 8, 64, 128, 64, "bf16"),
    (3, 16, 96, 384, 128, "f32"),
]


def err(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def host(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def inputs(E, C, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, d)).astype(np.float32),
            (rng.standard_normal((E, d, f)) * 0.05).astype(np.float32),
            (rng.standard_normal((E, f, d)) * 0.05).astype(np.float32))


def both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("E,C,d,f,f_tile,dtype", MOE_CASES)
def test_moe_ffn_matches_reference(E, C, d, f, f_tile, dtype):
    (jx, jwu, jwd), (tx, twu, twd) = both(inputs(E, C, d, f, E * 100 + C),
                                          dtype)
    M.moe_ffn.launches = 0
    y = M.moe_ffn(tx, twu, twd, "gelu", f_tile)
    assert y.dtype == tx.dtype and y.shape == (E, C, d)
    assert M.moe_ffn.launches == 0            # the plain version ran
    want = jax_moe_ffn(jx, jwu, jwd, activation=jax.nn.gelu, f_tile=f_tile,
                       interpret=True)
    assert err(host(y), host(want)) < TOL[dtype]
    # the port's oracle: each token routed to its own expert, gate 1
    tokens = tx.reshape(E * C, d)
    assign = torch.arange(E).repeat_interleave(C)[:, None]
    oracle = moe_gemm_ref(tokens, twu, twd, assign,
                          torch.ones((E * C, 1)), "gelu")
    assert err(host(y), host(oracle).reshape(E, C, d)) < TOL[dtype]


def test_moe_ffn_f_tile_invariance():
    """The result does not depend on the tiling beyond f32 reassociation."""
    (_, (tx, twu, twd)) = both(inputs(2, 16, 64, 256, 3), "f32")
    y1 = M.moe_ffn(tx, twu, twd, f_tile=64)
    y2 = M.moe_ffn(tx, twu, twd, f_tile=256)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_moe_gemm_ref_matches_reference(act):
    """Top-2 routing with gates through both packages' oracles."""
    rng = np.random.default_rng(4)
    T, E, d, f = 24, 4, 32, 64
    x = rng.standard_normal((T, d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) * 0.1).astype(np.float32)
    assign = np.stack([rng.permutation(E)[:2] for _ in range(T)]).astype(
        np.int32)
    gates = rng.uniform(0, 1, (T, 2)).astype(np.float32)
    jact = {"gelu": jax.nn.gelu, "relu": jax.nn.relu, "silu": jax.nn.silu}
    want = jax_moe_gemm_ref(*map(jnp.asarray, (x, wu, wd, assign, gates)),
                            activation=jact[act])
    got = moe_gemm_ref(*map(torch.from_numpy, (x, wu, wd, assign, gates)),
                       act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_moe_ffn_rejects_bad_shapes():
    _, (tx, twu, twd) = both(inputs(2, 8, 32, 96, 5), "f32")
    with pytest.raises(ValueError, match="multiple of f_tile"):
        M.moe_ffn(tx, twu, twd, f_tile=64)
    with pytest.raises(ValueError, match="do not fit"):
        M.moe_ffn(tx, twu[:, :16], twd, f_tile=32)
    meta = torch.zeros((2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        M.moe_ffn(meta, twu.to("meta"), twd.to("meta"), f_tile=32)


# expert widths of the model configs (d_model, d_ff, n_experts) with a
# capacity C and an f_tile that divides f
CONFIG_CASES = [
    ("granite_moe_1b_a400m", 640, 512),
    ("granite_moe_1b_a400m", 640, 128),
    ("deepseek_moe_16b", 384, 128),
    ("deepseek_moe_16b", 33, 704),
]


def _config_shape(name):
    import importlib

    cfg = importlib.import_module(f"repro.configs.{name}").CONFIG
    return cfg.n_experts, cfg.d_model, cfg.d_ff


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "case", [c[:5] for c in MOE_CASES] + CONFIG_CASES,
    ids=[f"moe{i}" for i in range(len(MOE_CASES))]
    + [f"{n}-C{C}-ft{ft}" for n, C, ft in CONFIG_CASES])
def test_moe_tile_plan_fits(case, dtype):
    """The launch plan takes every shape: within 232,448 B of shared memory,
    chunks of f that cover f (multiples of the kernel's K step when there
    is more than one), and a staging route the shape allows."""
    if isinstance(case[0], str):
        name, C, f_tile = case
        E, d, f = _config_shape(name)
    else:
        E, C, d, f, f_tile = case
    assert f % f_tile == 0
    tdt = DTYPES[dtype][1]
    plan = M.moe_tile_plan(E, C, d, f, tdt)
    assert plan.smem + (64 if dtype == "bf16" else 0) <= 232448
    assert plan.n_chunks * plan.f_chunk >= f > (plan.n_chunks - 1) * plan.f_chunk
    if dtype == "bf16":
        assert plan.rows in (64, 128)
        assert 2 <= plan.stages <= 4
        assert plan.n_chunks == 1 or plan.f_chunk % 64 == 0
        assert plan.route == ("tma" if d % 8 == 0 and f % 8 == 0
                              else "loads")
    else:
        assert (plan.rows, plan.stages) == (64, 2)
        assert plan.n_chunks == 1 or plan.f_chunk % 128 == 0
        assert 2 * (plan.smem + 1024) <= 233472      # two CTAs per SM
        assert plan.route == ("cp.async16" if d % 4 == 0 and f % 4 == 0
                              else "cp.async4")


def test_moe_tile_plan_granite_default():
    """At Granite's widths h for all of f stays on chip in bf16."""
    plan = M.moe_tile_plan(32, 640, 1024, 512, torch.bfloat16)
    assert (plan.rows, plan.f_chunk, plan.n_chunks, plan.route) == \
        (128, 512, 1, "tma")
    assert M.moe_tile_plan(32, 640, 1024, 512, torch.bfloat16,
                           rows=64).rows == 64
    with pytest.raises(ValueError, match="64 or 128"):
        M.moe_tile_plan(32, 640, 1024, 512, torch.bfloat16, rows=96)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: see README)")
    return torch.device("cuda")


# beyond MOE_CASES: one and 33 token rows, rows that are not 16-byte
# multiples (bf16's loads route, f32's 4-byte copies), more than one chunk
# of f in bf16, and two bf16 warpgroups (C > 64)
CUDA_MOE_CASES = MOE_CASES + [
    (2, 1, 64, 128, 64, "bf16"),
    (2, 33, 64, 128, 64, "f32"),
    (2, 33, 128, 256, 128, "bf16"),
    (3, 40, 100, 200, 100, "bf16"),
    (3, 40, 98, 198, 66, "f32"),
    (2, 70, 256, 1408, 128, "bf16"),
    (2, 130, 128, 640, 128, "f32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f,f_tile,dtype", CUDA_MOE_CASES)
def test_cuda_moe_ffn_matches_plain(cuda_device, E, C, d, f, f_tile, dtype):
    _, ts = both(inputs(E, C, d, f, 7), dtype)
    tx, twu, twd = (t.to(cuda_device) for t in ts)
    M.moe_ffn.launches = 0
    y = M.moe_ffn(tx, twu, twd, "gelu", f_tile)
    y_ref = M.moe_ffn_plain(tx, twu, twd, "gelu", f_tile)
    assert M.moe_ffn.launches == 1
    assert err(host(y.cpu()), host(y_ref.cpu())) < TOL[dtype]
