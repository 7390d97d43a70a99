"""Occupancy gating: the port's gated forwards and measured dynamic I/O
against the reference's, on the CPU.

Gating only skips contributions that are exactly zero, so a gated forward
must be bit-identical to the ungated one on each of the port's backends
(``kernel``: the gated megakernel's plain version; ``torch``: the masked
segment lowering).  Against the reference (``jnp`` and Pallas
``interpret``) outputs agree within f32 ``rtol = atol = 1e-5`` and bf16
3e-2, since the two sum in different orders; the dynamic I/O reports are
integer counts and must be equal as dicts.  Dead tiles are built with a
margin (bias -10 under relu, exact zero input tiles), so no count can
differ through rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import FakeClock

from repro.engine import Engine as JaxEngine
from repro.engine import backends as jbackends
from repro.serving import BucketedPlanSet as JaxPlanSet
from repro.serving import SparseServer as JaxServer
from repro_torch.convert import layers_from_numpy
from repro_torch.engine import Engine
from repro_torch.kernels import bsr_matmul as K
from repro_torch.obs import Tracer
from repro_torch.serving import BucketedPlanSet, SparseServer
from test_torch_kernels import (FLAT_CASES, JAX_ACT, flat_schedules,
                                mega_emulate)

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}
PORT_BACKENDS = ("kernel", "torch")
# the reference backend each port backend mirrors
JAX_BACKEND = {"kernel": "interpret", "torch": "jnp"}


def kill_tiles(layers, frac, bias_val=-10.0):
    """Force ``frac`` of every hidden layer's output tiles dead: a large
    negative bias keeps each pre-activation in the tile below zero, so relu
    zeroes the tile (the reference's ``_kill_tiles``).  Even hidden layers
    lose their first tiles and odd ones their last, so that no two hidden
    layers share an occupancy pattern."""
    out = []
    for k, lay in enumerate(layers):
        if k < len(layers) - 1:
            kill = int(frac * lay.grid_out)
            bias = np.array(lay.bias, np.float32)
            tiles = bias.reshape(lay.grid_out, lay.block_n)
            tiles[slice(None, kill) if k % 2 == 0
                  else slice(lay.grid_out - kill, None)] = bias_val
            lay = dataclasses.replace(lay, bias=bias)
        out.append(lay)
    return out


def zero_input_tiles(x, block, n_tiles):
    x = np.array(x)
    x[:, : n_tiles * block] = 0.0
    return x


def out(y) -> np.ndarray:
    return y.float().numpy() if isinstance(y, torch.Tensor) else \
        np.asarray(jnp.asarray(y, jnp.float32))


def port_pair(jlayers, backend, **kw):
    tl = layers_from_numpy(jlayers)
    gated = Engine(device="cpu", backend=backend, gate=True, **kw).compile(tl)
    ungated = Engine(device="cpu", backend=backend, **kw).compile(tl)
    return gated, ungated


# --------------------------------------------------------------------------- #
# gated == ungated, bit for bit
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_gated_bit_exact_with_dead_tiles(make_stack, backend, batch):
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128)), 0.5)
    gated, ungated = port_pair(jl, backend, activation="relu")
    x = np.random.default_rng(1).standard_normal((batch, 128)).astype(
        np.float32)
    K.reset_launches()
    y = gated(x)
    assert gated.fused and gated.gate and "+gated" in gated.describe()
    assert torch.equal(y, ungated(x))
    assert K.bsr_megakernel.gated_launches == 0     # plain versions on CPU
    want = JaxEngine(backend="jnp", activation="relu", gate=True).compile(
        jl)(jnp.asarray(x))
    np.testing.assert_allclose(out(y), out(want), **TOL["f32"])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_gated_bit_exact_with_zero_input_tiles(make_stack, backend, xdt):
    jl = make_stack(sizes=(128, 256, 128))
    gated, ungated = port_pair(jl, backend, activation="relu")
    x = zero_input_tiles(np.random.default_rng(2).standard_normal(
        (5, 128)).astype(np.float32), 32, 2)
    tx = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16"
                                else torch.float32)
    y = gated(tx)
    assert y.dtype == tx.dtype and torch.equal(y, ungated(tx))
    jx = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    want = JaxEngine(backend=JAX_BACKEND[backend], activation="relu",
                     gate=True).compile(jl)(jx)
    np.testing.assert_allclose(out(y), out(want), **TOL[xdt])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_gated_layered_path_bit_exact(make_stack, backend):
    """fuse=False: the torch lowering gates each layer's gather; the layered
    kernel path (bsr_matmul) has no gating and says so in the reference's
    own words."""
    jl = kill_tiles(make_stack(sizes=(128, 256, 128)), 0.5)
    gated, ungated = port_pair(jl, backend, activation="relu", fuse=False)
    x = np.random.default_rng(3).standard_normal((3, 128)).astype(np.float32)
    assert torch.equal(gated(x), ungated(x))
    jplan = JaxEngine(backend=JAX_BACKEND[backend], activation="relu",
                      fuse=False, gate=True).compile(jl)
    assert gated.fallback_reason == jplan.fallback_reason
    if backend == "kernel":
        assert "occupancy gating inactive on the layered pallas path" in \
            gated.describe()
    else:
        assert gated.fallback_reason is None


# --------------------------------------------------------------------------- #
# measured dynamic I/O equals the reference's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("wdt", ["f32", "bf16", "fp8"])
def test_measure_dynamic_equals_reference(make_stack, backend, wdt):
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128)), 0.5)
    x = zero_input_tiles(np.random.default_rng(6).standard_normal(
        (5, 128)).astype(np.float32), 32, 1)
    kw = dict(activation="relu", gate=True, weight_dtype=wdt)
    tplan = Engine(device="cpu", backend=backend, **kw).compile(
        layers_from_numpy(jl))
    jplan = JaxEngine(backend=JAX_BACKEND[backend], **kw).compile(jl)
    rep, jrep = tplan.measure_dynamic(x), jplan.measure_dynamic(x)
    assert rep.to_dict() == jrep.to_dict()
    assert 0.0 < rep.read_fraction < 1.0
    assert rep.per_layer_dynamic[0] < rep.per_layer_static[0]
    assert tplan.io.dynamic is rep
    assert tplan.io.to_dict() == jplan.io.to_dict()
    assert "dynamic I/O" in tplan.describe()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sigmoid_underflow_rows_stay_dead(backend):
    """The reference's pad-row case: every hidden pre-activation is below
    -150, so f32 sigmoid underflows to exact 0 and layer 1 reads nothing."""
    from repro.sparse import prune_dense_stack

    ws = [np.full((64, 64), -3.0, np.float32) for _ in range(2)]
    bs = [np.zeros(64, np.float32) for _ in range(2)]
    jl = prune_dense_stack(ws, bs, density=1.0, block_m=32, block_n=32)
    x = np.random.default_rng(5).uniform(1.0, 2.0, (3, 64)).astype(
        np.float32)
    gated, ungated = port_pair(jl, backend, activation="sigmoid")
    assert torch.equal(gated(x), ungated(x))
    rep = gated.measure_dynamic(x)
    assert rep.per_layer_live_tiles[1] == 0 and rep.per_layer_dynamic[1] == 0
    jrep = JaxEngine(backend=JAX_BACKEND[backend], activation="sigmoid",
                     gate=True).compile(jl).measure_dynamic(x)
    assert rep.to_dict() == jrep.to_dict()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_negative_epilogue_tiles_stay_live(make_stack, backend):
    """tanh(-10) is -1, not 0: tiles the bias pushes negative stay live, so
    the occupancy counts nonzero values, not positive ones."""
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128)), 0.5)
    gated, ungated = port_pair(jl, backend, activation="tanh")
    x = np.random.default_rng(13).standard_normal((3, 128)).astype(
        np.float32)
    assert torch.equal(gated(x), ungated(x))
    rep = gated.measure_dynamic(x)
    assert rep.per_layer_live_tiles == rep.per_layer_in_tiles
    jrep = JaxEngine(backend=JAX_BACKEND[backend], activation="tanh",
                     gate=True).compile(jl).measure_dynamic(x)
    assert rep.to_dict() == jrep.to_dict()


def test_kernel_occupancy_output_matches_torch(make_stack):
    """The megakernel's own hidden occupancy equals ``tile_occupancy`` of
    the hidden activations, layer by layer."""
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128)), 0.25)
    x = np.random.default_rng(7).standard_normal((5, 128)).astype(np.float32)
    tl = layers_from_numpy(jl)
    plans = [Engine(device="cpu", backend=b, activation="relu",
                    gate=True).compile(tl) for b in PORT_BACKENDS]
    (yk, ok), (yt, ot) = [p._measure(torch.from_numpy(x)) for p in plans]
    assert len(ok) == len(ot) == 3
    for a, b in zip(ok, ot):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    np.testing.assert_allclose(out(yk), out(yt), **TOL["f32"])


@pytest.mark.parametrize("sizes,density,xdt,wdt,batch,act", FLAT_CASES)
def test_gated_megakernel_emulation_matches_pallas(make_stack, sizes, density,
                                                   xdt, wdt, batch, act):
    """The gated megakernel's decomposition on the CPU (dead steps compute
    no product and write zero partials; live rows counted per 32-row chunk)
    against the reference's gated Pallas megakernel (interpret): output
    within tolerance and bit-equal to the ungated emulation, per-chunk
    counts summing to the reference's occupancy."""
    jls = kill_tiles(make_stack(sizes=sizes, density=density, block=32,
                                seed=batch), 0.5)
    jflat, tflat = flat_schedules(jls, wdt)
    acts = [JAX_ACT[act]] * (len(jls) - 1) + [None]
    measure = jbackends.make_fused_measure(jls, jflat, acts, "interpret")
    x = zero_input_tiles(np.random.default_rng(batch).standard_normal(
        (batch, sizes[0])).astype(np.float32), 32, 1)
    jx = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16"
                                else torch.float32)
    y_ref, occs_ref = measure(jx)
    y, slots = mega_emulate(tx, tflat, act, "none", gate=True)
    assert torch.equal(y, mega_emulate(tx, tflat, act, "none"))
    np.testing.assert_allclose(out(y), out(y_ref), **TOL[xdt])
    chunks = -(-batch // 32)
    assert len(slots) == len(jls) - 1
    for k, sl in enumerate(slots):
        assert sl.shape == (jls[k].grid_out, chunks)
        np.testing.assert_array_equal(sl.sum(dim=1).numpy(),
                                      np.asarray(occs_ref[k + 1]))
    if act == "relu":       # the killed tiles are dead: gating skips steps
        assert any(not (sl > 0).any(dim=1).all() for sl in slots)


def test_measure_dynamic_requires_gated_fused(make_stack):
    tl = layers_from_numpy(make_stack())
    x = np.random.default_rng(8).standard_normal((2, 128)).astype(np.float32)
    for plan in (Engine(device="cpu", activation="relu").compile(tl),
                 Engine(device="cpu", activation="relu", gate=True,
                        fuse=False).compile(tl)):
        with pytest.raises(RuntimeError, match="gated fused plan"):
            plan.measure_dynamic(x)
    gated = Engine(device="cpu", activation="relu", gate=True).compile(tl)
    with pytest.raises(ValueError, match="expected input"):
        gated.measure_dynamic(x[:, :64])
    with pytest.raises(ValueError, match="occ0"):
        K.bsr_megakernel(torch.from_numpy(x), gated.flat, "relu", "none",
                         gate=True)


def test_fresh_forward_keeps_gating_and_safe_twin_drops_it(make_stack):
    jl = kill_tiles(make_stack(sizes=(128, 256, 128)), 0.5)
    plan = Engine(device="cpu", activation="relu", gate=True).compile(
        layers_from_numpy(jl))
    x = np.random.default_rng(10).standard_normal((4, 128)).astype(
        np.float32)
    fresh = plan.with_fresh_forward()
    assert fresh.gate and fresh._measure is not None
    assert torch.equal(fresh(x), plan(x))
    assert fresh.measure_dynamic(x) == plan.measure_dynamic(x)
    twin = plan.safe_twin()
    assert (twin.backend, twin.gate, twin._measure, twin.fused) == (
        "kernel", False, None, False)
    np.testing.assert_allclose(out(twin(x)), out(plan(x)), **TOL["f32"])


def test_gated_and_ungated_plans_never_alias(make_stack):
    tl = layers_from_numpy(make_stack())
    p = Engine(device="cpu", activation="relu").compile(tl)
    gp = Engine(device="cpu", activation="relu", gate=True).compile(tl)
    assert p is not gp and not p.gate and gp.gate


def test_trace_attrs_equal_reference(make_stack):
    from repro.obs.telemetry import plan_io_attrs

    jl = kill_tiles(make_stack(sizes=(128, 256, 128)), 0.5)
    x = np.random.default_rng(11).standard_normal((3, 128)).astype(
        np.float32)
    tplan = Engine(device="cpu", backend="torch", activation="relu",
                   gate=True, weight_dtype="bf16").compile(
        layers_from_numpy(jl))
    jplan = JaxEngine(backend="jnp", activation="relu", gate=True,
                      weight_dtype="bf16").compile(jl)
    tplan.measure_dynamic(x)
    jplan.measure_dynamic(x)
    attrs = tplan.trace_attrs()
    assert attrs["io_read_fraction"] < 1.0
    assert attrs == {**plan_io_attrs(jplan), "backend": "torch"}


# --------------------------------------------------------------------------- #
# serving: sampled dynamic I/O telemetry
# --------------------------------------------------------------------------- #

def serve_stream(server, rows, bursts):
    i = 0
    for n in bursts:
        for x in rows[i:i + n]:
            server.submit(x)
        i += n
        server.poll()
    server.drain()


def test_server_io_telemetry_equals_reference(make_stack):
    jl = kill_tiles(make_stack(sizes=(128, 256, 128)), 0.5)
    kw = dict(activation="relu", gate=True, reorder=True, reorder_iters=50)
    jplans = JaxPlanSet.compile(jl, engine=JaxEngine(backend="jnp", **kw),
                                max_batch=4).warmup()
    tplans = BucketedPlanSet.compile(layers_from_numpy(jl),
                                     engine=Engine(device="cpu", **kw),
                                     max_batch=4).warmup()
    rng = np.random.default_rng(12)
    rows = zero_input_tiles(rng.standard_normal((19, 128)).astype(
        np.float32), 32, 2)
    bursts = [3, 1, 4, 2, 4, 1, 3, 1]
    jserver = JaxServer(jplans, clock=FakeClock(), measure_dynamic_every=1)
    tracer = Tracer()
    tserver = SparseServer(tplans, clock=FakeClock(), tracer=tracer,
                           measure_dynamic_every=1)
    serve_stream(jserver, rows, bursts)
    serve_stream(tserver, rows, bursts)
    snap = tserver.io.snapshot()
    assert snap == jserver.io.snapshot()
    assert snap["batches_measured"] == tserver.metrics.batches
    assert 0.0 < snap["read_fraction"] < 1.0
    assert tserver.metrics.io_measure_failed == 0
    events = [s for s in tracer.spans() if s.name == "io.measure"]
    assert len(events) == tserver.metrics.batches


def test_server_counts_a_failed_measurement_and_serves(make_stack):
    tl = layers_from_numpy(make_stack(sizes=(64, 128, 64)))
    plans = BucketedPlanSet.compile(
        tl, engine=Engine(device="cpu", activation="relu", gate=True),
        max_batch=2).warmup()

    def broken(x):
        raise FloatingPointError("boom")

    plans.base._measure = broken
    tracer = Tracer()
    server = SparseServer(plans, clock=FakeClock(), tracer=tracer,
                          measure_dynamic_every=2)
    rids = [server.submit(np.ones(64, np.float32)) for _ in range(4)]
    server.drain()
    assert all(server.result(r) is not None for r in rids)
    assert server.metrics.batches == 2
    assert server.metrics.io_measure_failed == 1      # every 2nd batch
    assert server.metrics.snapshot()["io_measure_failed"] == 1
    failed = [s for s in tracer.spans() if s.name == "io.measure_failed"]
    assert [s.attrs["error"] for s in failed] == ["FloatingPointError"]
    assert server.io.snapshot()["batches_measured"] == 0


def test_serve_gate_entry_point_on_cpu(capsys):
    from repro_torch.launch import serve

    args = serve.parse_args(["--sparse-ffnn", "--device", "cpu", "--gate",
                             "--ffnn-sizes", "128", "256", "128",
                             "--block", "32", "--requests", "12",
                             "--reorder-iters", "30"])
    report = serve.serve_sparse_ffnn(args)
    text = capsys.readouterr().out
    assert "ExecutionPlan[kernel/fused+gated on cpu]" in text
    assert "dynamic I/O at B=4: read" in text
    server = report.server
    assert server.io.snapshot()["batches_measured"] == server.metrics.batches
    rids = sorted(report.inputs)
    x = np.stack([report.inputs[r] for r in rids])
    want = server.plans.base.safe_twin()(x).numpy()
    got = np.stack([report.outputs[r] for r in rids])
    np.testing.assert_allclose(got, want, **TOL["f32"])


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", ("f32", "bf16", "fp8"))
def test_cuda_gated_megakernel_matches_plain(make_stack, cuda_device, wdt):
    """The gated megakernel on the card: occupancy equal to the plain
    version's, output bit-equal to the ungated kernel's, odd batch."""
    from repro_torch.engine import tile_occupancy

    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128)), 0.5)
    plan = Engine(device=cuda_device, activation="relu", gate=True,
                  weight_dtype=wdt).compile(layers_from_numpy(jl))
    x = zero_input_tiles(np.random.default_rng(0).standard_normal(
        (5, 128)).astype(np.float32), 32, 1)
    x = torch.from_numpy(x).to(cuda_device)
    occ0 = tile_occupancy(x, 32, 4)
    K.reset_launches()
    y, occ = K.bsr_megakernel(x, plan.flat, "relu", "none", gate=True,
                              occ0=occ0)
    y_ref, occ_ref = K.bsr_megakernel_plain(x, plan.flat, "relu", "none",
                                            gate=True, occ0=occ0)
    assert torch.equal(occ.cpu(), occ_ref.cpu())
    assert torch.equal(y, K.bsr_megakernel(x, plan.flat, "relu", "none"))
    assert not plan.flat.arrivals.any()     # each run's reducer reset them
    np.testing.assert_allclose(out(y.cpu()), out(y_ref.cpu()), rtol=1e-4,
                               atol=1e-4)
    assert (K.bsr_megakernel.gated_launches, K.bsr_megakernel.launches) == \
        (1, 1)
