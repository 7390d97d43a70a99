"""The fused AdamW pass (``repro_torch.kernels.adamw``) on the CPU.

The kernel (``csrc/adamw.cu``) follows the plain version's order of
correctly rounded f32 operations, so the two must agree bit for bit.  Here,
without the card: a numpy f32 emulation of the kernel's per-element order
equals the ``torch._foreach_*`` plain version bit for bit, on random state
from a fixed seed, for bf16 and f32 parameters; the wrapper takes the plain
route on CPU tensors (no launch counted), gives a ``meta`` trace the
kernel's outputs only, and raises on CUDA tensors when no kernel library
can be built; ``adamw_update`` hands the wrapper one group per ``_GROUP``
elements and matches the reference's update.  The kernel against its plain
version on the card is marked ``cuda`` (``chip_smoke.py`` phase 10 runs it
on granite-moe-1b-a400m's full-width state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_update as jadamw_update
from repro_torch.kernels import adamw as A
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as optim_adamw

SHAPES = [(7, 13), (4096 + 3,), (2, 3, 5), (1,)]
HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _state(seed=0, shapes=SHAPES):
    """Random grads, master, mu and nu (nu >= 0) and the step's scalars, as
    numpy f32, some gradients near zero (where Adam is most sensitive)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    st = {"g": [], "m": [], "mu": [], "nu": []}
    for shape in shapes:
        g = rng.standard_normal(shape).astype(f) * f(0.3)
        g.reshape(-1)[::5] *= f(1e-7)
        st["g"].append(g)
        st["m"].append(rng.standard_normal(shape).astype(f))
        st["mu"].append(rng.standard_normal(shape).astype(f) * f(0.01))
        st["nu"].append(np.abs(rng.standard_normal(shape)).astype(f)
                        * f(1e-4))
    scalars = {"scale": f(0.73), "lr": f(2.9e-4), "bc1": f(1 - 0.9 ** 3),
               "bc2": f(1 - 0.95 ** 3)}
    return st, scalars


def _emulate(st, sc, b1, b2, eps, weight_decay):
    """The kernel's per-element order in numpy f32, one correctly rounded
    operation at a time (csrc/adamw.cu)."""
    f = np.float32
    b1_, omb1, b2_, omb2 = f(b1), f(1 - b1), f(b2), f(1 - b2)
    eps_, wd = f(eps), f(weight_decay)
    out = {"m": [], "mu": [], "nu": []}
    for g0, m, mu, nu in zip(st["g"], st["m"], st["mu"], st["nu"]):
        g = g0 * sc["scale"]
        mu = mu * b1_
        mu = mu + g * omb1
        gg = g * omb2
        gg = gg * g
        nu = nu * b2_
        nu = nu + gg
        den = np.sqrt(nu / sc["bc2"]) + eps_
        upd = (mu / sc["bc1"]) / den
        upd = upd + m * wd
        upd = upd * sc["lr"]
        m = m - upd
        for k, v in (("m", m), ("mu", mu), ("nu", nu)):
            assert v.dtype == np.float32
            out[k].append(v)
    return out


def _torch(st, sc, device="cpu"):
    tt = {k: [torch.from_numpy(x.copy()).to(device) for x in v]
          for k, v in st.items()}
    ts = {k: torch.tensor(v, device=device) for k, v in sc.items()}
    return tt, ts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_emulated_equals_plain_bit_for_bit(dtype, seed):
    st, sc = _state(seed)
    want = _emulate(st, sc, **HP)
    tt, ts = _torch(st, sc)
    outs = A.adamw_plain(tt["g"], tt["m"], tt["mu"], tt["nu"],
                         [dtype] * len(SHAPES), ts["scale"], ts["lr"],
                         ts["bc1"], ts["bc2"], **HP)
    for k in ("m", "mu", "nu"):
        for a, b in zip(tt[k], want[k]):
            assert a.numpy().tobytes() == b.tobytes(), k
    for o, m in zip(outs, want["m"]):
        assert o.dtype == dtype
        # bf16: round to nearest even, as __float2bfloat16_rn
        assert torch.equal(o, torch.from_numpy(m).to(dtype))


def test_wrapper_takes_the_plain_route_on_the_cpu():
    st, sc = _state(2)
    a, sa = _torch(st, sc)
    b, sb = _torch(st, sc)
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32]
    before = A.adamw_fused.launches
    got = A.adamw_fused(a["g"], a["m"], a["mu"], a["nu"], dtypes,
                        sa["scale"], sa["lr"], sa["bc1"], sa["bc2"], **HP)
    want = A.adamw_plain(b["g"], b["m"], b["mu"], b["nu"], dtypes,
                         sb["scale"], sb["lr"], sb["bc1"], sb["bc2"], **HP)
    assert A.adamw_fused.launches == before
    for x, y in zip(got + a["m"] + a["mu"] + a["nu"],
                    want + b["m"] + b["mu"] + b["nu"]):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_meta_trace_gets_the_kernels_outputs_only():
    st, sc = _state(3)
    tt, ts = _torch(st, sc, "meta")
    outs = A.adamw_fused(tt["g"], tt["m"], tt["mu"], tt["nu"],
                         [torch.bfloat16] * len(SHAPES), ts["scale"],
                         ts["lr"], ts["bc1"], ts["bc2"], **HP)
    assert [tuple(o.shape) for o in outs] == SHAPES
    assert all(o.is_meta and o.dtype == torch.bfloat16 for o in outs)


def test_wrapper_raises_on_cuda_tensors_without_a_kernel_library(
        monkeypatch):
    """No plain route for a CUDA tensor: the wrapper builds the library or
    raises (here, where no nvcc exists, with the build's error)."""
    monkeypatch.setattr(A._build, "_lib", None)
    monkeypatch.setattr(A._build, "library_path",
                        lambda: A._build.BUILD_DIR / "absent.so")

    def no_nvcc():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")

    monkeypatch.setattr(A._build, "_nvcc", no_nvcc)
    with FakeTensorMode(allow_non_fake_inputs=True):
        z = [torch.zeros(4, device="cuda") for _ in range(4)]
        s = torch.ones((), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            A.adamw_fused([z[0]], [z[1]], [z[2]], [z[3]], [torch.float32],
                          s, s, s, s, **HP)
        with pytest.raises(ValueError, match="contiguous f32"):
            A.adamw_fused([z[0]], [z[1].to(torch.bfloat16)], [z[2]], [z[3]],
                          [torch.float32], s, s, s, s, **HP)


def test_leaf_table_packs_each_leaf_and_its_first_chunk():
    tt, _ = _torch(*_state(4))
    outs = [torch.empty_like(m) for m in tt["m"]]
    table, n_chunks = A.leaf_table(tt["g"], tt["m"], tt["mu"], tt["nu"],
                                   outs)
    chunks = [-(-m.numel() // A.CHUNK) for m in tt["m"]]
    assert n_chunks == sum(chunks)
    assert table.shape == (len(SHAPES), 8)
    assert list(table[:, 7]) == list(np.cumsum([0] + chunks[:-1]))
    assert list(table[:, 5]) == [m.numel() for m in tt["m"]]
    assert list(table[:, 0]) == [g.data_ptr() for g in tt["g"]]


def test_update_groups_and_matches_the_reference(monkeypatch):
    """``adamw_update`` calls the wrapper once per group of at most
    ``_GROUP`` elements (a small ``_GROUP`` here), and the update equals
    the reference's within f32 rounding."""
    monkeypatch.setattr(optim_adamw, "_GROUP", 100)
    calls = []
    fused = optim_adamw.adamw_fused

    def spy(grads, *args, **kw):
        calls.append(sum(g.numel() for g in grads))
        return fused(grads, *args, **kw)

    monkeypatch.setattr(optim_adamw, "adamw_fused", spy)
    rng = np.random.default_rng(5)
    shapes = {"a": (10, 9), "b": (40,), "c": (3, 50), "d": (2,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    state = adamw_init(tp)
    new, state, met = adamw_update({n: torch.from_numpy(g)
                                    for n, g in grads.items()},
                                   state, tp, OptConfig(**cfg))
    assert calls == [90, 40, 150, 2]
    jnew, jstate, jmet = jadamw_update(
        {n: jnp.asarray(g) for n, g in grads.items()},
        jax.tree.map(jnp.asarray, {
            "master": params, "step": np.zeros((), np.int32),
            "mu": {n: np.zeros(s, np.float32) for n, s in shapes.items()},
            "nu": {n: np.zeros(s, np.float32) for n, s in shapes.items()}}),
        {n: jnp.asarray(v) for n, v in params.items()}, JOptConfig(**cfg))
    for n in shapes:
        np.testing.assert_allclose(new[n].numpy(), np.asarray(jnew[n]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(state["nu"][n].numpy(),
                                   np.asarray(jstate["nu"][n]), rtol=1e-6,
                                   atol=1e-12)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python3 "
                    "chip_smoke.py, phase 10)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain_on_the_card(dtype, cuda_device):
    st, sc = _state(6, SHAPES + [(3, 1 << 20)])
    a, sa = _torch(st, sc, cuda_device)
    b, sb = _torch(st, sc, cuda_device)
    n = len(a["m"])
    before = A.adamw_fused.launches
    got = A.adamw_fused(a["g"], a["m"], a["mu"], a["nu"], [dtype] * n,
                        sa["scale"], sa["lr"], sa["bc1"], sa["bc2"], **HP)
    want = A.adamw_plain(b["g"], b["m"], b["mu"], b["nu"], [dtype] * n,
                         sb["scale"], sb["lr"], sb["bc1"], sb["bc2"], **HP)
    torch.cuda.synchronize()
    assert A.adamw_fused.launches == before + 1
    for x, y in zip(got + a["m"] + a["mu"] + a["nu"],
                    want + b["m"] + b["mu"] + b["nu"]):
        assert torch.equal(x, y)
