"""Engine parity: ``Engine(device="cpu")`` against the reference's
``Engine(backend="jnp")`` on the same nets and settings.

Connection orders, every ``artifact_arrays()`` entry and ``io.to_dict()``
must be exactly equal (quantized blocks as raw bytes).  Outputs agree within
f32 ``rtol = atol = 1e-5`` on the CPU: the port's kernel backend (the plain
versions) and torch backend both accumulate in f32, in another order than
the reference's ``segment_sum``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocksparse import to_bsr
from repro.engine import Engine as JaxEngine
from repro_torch.convert import layers_from_numpy
from repro_torch.engine import Engine

TOL = dict(rtol=1e-5, atol=1e-5)

SETTINGS = [
    dict(),
    dict(reorder=True, reorder_iters=200, seed=3),
    dict(fuse=False),
    dict(reorder=True, reorder_iters=100, seed=1, fuse=False),
    dict(weight_dtype="bf16", activation="gelu"),
    dict(weight_dtype="fp8", reorder=True, reorder_iters=100, seed=2),
    dict(activation="sigmoid", final_activation="tanh"),
]


def compile_both(jlayers, backend="kernel", **kw):
    jplan = JaxEngine(backend="jnp", **kw).compile(jlayers)
    tplan = Engine(device="cpu", backend=backend, **kw).compile(
        layers_from_numpy(jlayers))
    return jplan, tplan


def assert_artifacts_equal(jplan, tplan):
    ja, ta = jplan.artifact_arrays(), tplan.artifact_arrays()
    assert sorted(ja) == sorted(ta)
    for key in ja:
        a = np.asarray(ja[key])
        if key == "flat_qblocks":
            assert a.tobytes() == ta[key].tobytes()
            assert a.shape == ta[key].shape
        else:
            assert a.dtype == ta[key].dtype, key
            np.testing.assert_array_equal(a, ta[key], err_msg=key)


@pytest.mark.parametrize("kw", SETTINGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_plan_matches_reference(make_stack, kw):
    jlayers = make_stack(sizes=(128, 256, 192, 128), density=0.3, block=32)
    jplan, tplan = compile_both(jlayers, **kw)
    np.testing.assert_array_equal(jplan.order, tplan.order)
    assert tplan.fused == jplan.fused
    assert tplan.fallback_reason == jplan.fallback_reason
    assert_artifacts_equal(jplan, tplan)
    assert tplan.io.to_dict() == jplan.io.to_dict()
    assert tplan.annealer_iters == jplan.annealer_iters
    x = np.random.default_rng(0).standard_normal((5, 128)).astype(np.float32)
    want = np.asarray(jplan(jnp.asarray(x)))
    np.testing.assert_allclose(tplan(x).numpy(), want, **TOL)
    np.testing.assert_allclose(tplan.safe_twin()(x).numpy(), want, **TOL)


def test_non_uniform_tiles_fall_back_like_reference():
    rng = np.random.default_rng(4)
    jlayers = [
        to_bsr(rng.standard_normal((64, 128)).astype(np.float32) * 0.1, 32,
               64, density=0.6, bias=rng.standard_normal(128).astype(np.float32)),
        to_bsr(rng.standard_normal((128, 64)).astype(np.float32) * 0.1, 64,
               32, density=0.6, bias=rng.standard_normal(64).astype(np.float32)),
    ]
    jplan, tplan = compile_both(jlayers)
    assert not tplan.fused and tplan.fallback_reason == jplan.fallback_reason
    assert tplan.io.to_dict() == jplan.io.to_dict()
    x = rng.standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_allclose(tplan(x).numpy(),
                               np.asarray(jplan(jnp.asarray(x))), **TOL)


def test_mixed_hidden_epilogues_fall_back_to_layered(make_stack):
    jlayers = make_stack(sizes=(64, 128, 96, 64), density=0.5, block=32)
    jplan, tplan = compile_both(jlayers, activation=["relu", "gelu"])
    assert not tplan.fused and "ONE hidden-layer activation" in \
        tplan.fallback_reason
    assert tplan.fallback_reason == jplan.fallback_reason
    x = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    np.testing.assert_allclose(tplan(x).numpy(),
                               np.asarray(jplan(jnp.asarray(x))), **TOL)


def test_callable_epilogue_only_on_torch_backend(make_stack):
    tlayers = layers_from_numpy(make_stack(sizes=(64, 128, 64), block=32))
    with pytest.raises(ValueError, match="by name"):
        Engine(device="cpu", activation=torch.tanh).compile(tlayers)
    leaky = functools.partial(torch.nn.functional.leaky_relu,
                              negative_slope=0.1)
    plan = Engine(device="cpu", backend="torch",
                  activation=leaky).compile(tlayers)
    ref = Engine(device="cpu", backend="torch",
                 activation="relu").compile(tlayers)
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    assert plan(x).shape == ref(x).shape == (3, 64)
    assert plan.fused


def test_engine_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Engine()
    assert Engine(device="cpu").device == torch.device("cpu")


def test_gate_and_unknown_settings_are_refused():
    """gate=True is taken since the gated megakernel exists; unknown
    backends and weight dtypes are still refused."""
    assert Engine(device="cpu", gate=True).gate
    with pytest.raises(ValueError, match="unknown backend"):
        Engine(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        Engine(device="cpu", weight_dtype="int8")


def test_plans_are_cached_and_describe_themselves(make_stack):
    tlayers = layers_from_numpy(make_stack(sizes=(64, 128, 64), block=32))
    engine = Engine(device="cpu", reorder=True, reorder_iters=50)
    plan = engine.compile(tlayers)
    assert engine.compile(tlayers) is plan
    assert engine.compile(tlayers, backend="torch") is not plan
    plan(np.zeros((2, 64), np.float32))
    text = plan.describe()
    assert text.startswith("ExecutionPlan[kernel/fused on cpu]")
    assert "50 annealer iters" in text and "1 calls" in text
    single = plan(np.zeros(64, np.float32))
    assert single.shape == (64,)
    with pytest.raises(ValueError, match="expected input"):
        plan(np.zeros((2, 65), np.float32))
    with pytest.raises(RuntimeError, match="gated fused plan"):
        plan.measure_dynamic(np.zeros((2, 64), np.float32))


def test_compile_with_order_rebuilds_the_same_plan(make_stack):
    tlayers = layers_from_numpy(make_stack(density=0.3, block=32))
    engine = Engine(device="cpu", reorder=True, reorder_iters=100, seed=4,
                    weight_dtype="bf16")
    cold = engine.compile(tlayers)
    warm = engine.compile_with_order(tlayers, cold.order, io=cold.io)
    assert warm.annealer_iters == 0 and warm.io is cold.io
    for key, val in cold.artifact_arrays().items():
        np.testing.assert_array_equal(warm.artifact_arrays()[key], val)
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    torch.testing.assert_close(warm(x), cold(x), rtol=0, atol=0)


def test_io_report_round_trips(make_stack):
    from repro_torch.engine import IOReport

    plan = Engine(device="cpu", weight_dtype="fp8").compile(
        layers_from_numpy(make_stack(block=32)))
    assert IOReport.from_dict(plan.io.to_dict()).to_dict() == plan.io.to_dict()
    assert plan.io.within_bounds


def test_scheduled_sparse_ffnn_matches_engine(make_stack):
    from repro.sparse import ScheduledSparseFFNN as JaxFFNN
    from repro_torch.sparse import ScheduledSparseFFNN

    jlayers = make_stack(sizes=(64, 128, 64), block=32)
    jmodel = JaxFFNN.build(jlayers, reorder=True, reorder_iters=50,
                           backend="jnp")
    model = ScheduledSparseFFNN.build(layers_from_numpy(jlayers),
                                      reorder=True, reorder_iters=50,
                                      device="cpu")
    np.testing.assert_array_equal(model.order, jmodel.order)
    assert model.fused
    assert model.simulated_ios().reads == jmodel.simulated_ios().reads
    x = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    np.testing.assert_allclose(model(x).numpy(),
                               np.asarray(jmodel(jnp.asarray(x))), **TOL)
