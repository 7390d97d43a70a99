"""Sharded execution plans: the port's ``engine.sharding`` against the
reference's, on the shared test nets (``make_stack``).

Exactly equal to the reference: ``Mesh`` validation and parsing,
``partition_model``'s owned tiles and shard layers (and its error for a grid
the model axis does not divide), each shard's connection order and schedule
arrays (f32 and bf16 weights), ``ShardedIOReport.to_dict()``,
``artifact_arrays()`` and the plan-store files of a sharded entry, which
cross between the two stores in both directions.

Outputs of the port's ``torch`` backend and of its ``kernel`` backend (on
the CPU, the kernels' plain versions) agree with the reference's sharded
``jnp`` plan within f32 ``rtol = atol = 1e-5``, gated and ungated.  Bit for
bit: ``Mesh(1, 1)`` runs the unsharded plan's own forward, a batch padded
to the data axis gives the rows of the unpadded one, and the collective
lowering (four ``gloo`` processes) gives the sequential loop's answers.
CPU products of a single row take another path than those of several
(``gemv``), so the bit-equal checks keep at least two rows per data
replica.

The serving surfaces (``BucketedPlanSet``, ``SparseServer`` with a swap,
``ModelRouter``, ``serve --mesh``) answer every request.  The test that
needs the card is marked ``cuda`` and skips without one.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocksparse import to_block_ffnn as jax_block_ffnn
from repro.engine import Engine as JaxEngine
from repro.engine import Mesh as JaxMesh
from repro.engine.sharding import partition_model as jax_partition
from repro.serving import PlanStore as JaxStore
from repro.serving import plan_cache_key as jax_key
from repro_torch.checkpoint import write_manifest_dir
from repro_torch.convert import layers_from_numpy
from repro_torch.core.blocksparse import to_block_ffnn
from repro_torch.engine import (
    Engine,
    Mesh,
    ShardedExecutionPlan,
    ShardedIOReport,
    partition_model,
)
from repro_torch.engine import backends
from repro_torch.kernels import bsr_matmul as K
from repro_torch.launch import serve
from repro_torch.serving import (
    BucketedPlanSet,
    ModelRouter,
    PlanStore,
    SparseServer,
    plan_cache_key,
)
from repro_torch.serving.plancache import _artifact_dtypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = [(2, 1), (4, 1), (2, 2), (4, 2)]
MESH_IDS = [f"{m}x{d}" for m, d in MESHES]
# the collective test's own bound: a hang fails that test, not the suite
COLLECTIVE_TIMEOUT_S = 180.0


def kill_tiles(layers, frac=0.5):
    """Every hidden layer's first ``frac`` of output tiles dead under relu
    (bias -10), so gating has blocks to skip."""
    out = []
    for k, lay in enumerate(layers):
        if k < len(layers) - 1:
            bias = np.array(lay.bias, np.float32)
            bias.reshape(lay.grid_out, lay.block_n)[
                :int(lay.grid_out * frac)] = -10.0
            lay = type(lay)(**{**vars(lay), "bias": bias})
        out.append(lay)
    return out


def both(jl, mesh, backend="kernel", **kw):
    """The same sharded compile in both packages."""
    jplan = JaxEngine(backend="jnp", **kw).compile(jl, mesh=JaxMesh(*mesh))
    tplan = Engine(device="cpu", backend=backend, **kw).compile(
        layers_from_numpy(jl), mesh=Mesh(*mesh))
    return jplan, tplan


def assert_arrays_equal(ja, ta):
    assert sorted(ja) == sorted(ta)
    for key in ja:
        a = np.asarray(ja[key])
        assert a.shape == ta[key].shape, key
        if key.endswith("flat_qblocks"):
            assert a.tobytes() == ta[key].tobytes(), key
        else:
            assert a.dtype == ta[key].dtype, key
            np.testing.assert_array_equal(a, ta[key], err_msg=key)


def rows(n, width=128, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, width)).astype(np.float32)


# --------------------------------------------------------------------------- #
# mesh and partition
# --------------------------------------------------------------------------- #

def test_mesh_validation_and_parse_equal_reference():
    for bad in ((0, 1), (1, 0), (-2, 3)):
        with pytest.raises(ValueError) as te:
            Mesh(*bad)
        with pytest.raises(ValueError) as je:
            JaxMesh(*bad)
        assert str(te.value).replace("Mesh", "") == \
            str(je.value).replace("Mesh", "")
    for spec in ("4x2", "4", " 2X2 ", "1x1"):
        assert Mesh.parse(spec).shape == JaxMesh.parse(spec).shape
    for spec in ("4xq", "x2", ""):
        with pytest.raises(ValueError) as te:
            Mesh.parse(spec)
        with pytest.raises(ValueError) as je:
            JaxMesh.parse(spec)
        assert str(te.value) == str(je.value)
    assert Mesh(4, 2).size == 8 and Mesh().shape == (1, 1)
    assert Mesh(4, 2).process_mesh() is None       # no group: the loop


@pytest.mark.parametrize("model", (2, 4))
def test_partition_model_equals_reference(make_stack, model):
    jl = make_stack(sizes=(128, 256, 128), density=0.4, block=32)
    jspecs = jax_partition(jax_block_ffnn(jl), model)
    tspecs = partition_model(to_block_ffnn(layers_from_numpy(jl)), model)
    assert len(tspecs) == len(jspecs) == model
    for js, ts in zip(jspecs, tspecs):
        for a, b in zip(js.owned, ts.owned):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(js.bffnn.layers, ts.bffnn.layers):
            assert (a.n_in, a.n_out, a.block_m, a.block_n) == \
                (b.n_in, b.n_out, b.block_m, b.block_n)
            for name in ("rows", "cols", "blocks", "bias"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
        for name in ("src", "dst", "is_input", "is_output"):
            np.testing.assert_array_equal(getattr(js.bffnn.net, name),
                                          getattr(ts.bffnn.net, name))
        np.testing.assert_array_equal(js.bffnn.conn_layer,
                                      ts.bffnn.conn_layer)
        np.testing.assert_array_equal(js.bffnn.conn_block,
                                      ts.bffnn.conn_block)


def test_partition_indivisible_grid_raises_like_reference(make_stack):
    jl = make_stack(sizes=(128, 256, 128), block=32)   # 4 final tiles
    with pytest.raises(ValueError, match="divisible") as te:
        partition_model(to_block_ffnn(layers_from_numpy(jl)), 3)
    with pytest.raises(ValueError) as je:
        jax_partition(jax_block_ffnn(jl), 3)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="divisible"):
        Engine(device="cpu").compile(layers_from_numpy(jl), mesh=Mesh(3, 1))


# --------------------------------------------------------------------------- #
# per-shard artifacts and reports
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("wdt", ("f32", "bf16"))
@pytest.mark.parametrize("mesh", [(2, 1), (4, 1)], ids=["2x1", "4x1"])
def test_shard_orders_and_schedules_equal_reference(make_stack, mesh, wdt):
    jl = make_stack(sizes=(128, 256, 128), density=0.4, block=32)
    jplan, tplan = both(jl, mesh, weight_dtype=wdt, reorder=True,
                        reorder_iters=60, seed=2)
    assert isinstance(tplan, ShardedExecutionPlan)
    assert tplan.annealer_iters == jplan.annealer_iters == mesh[0] * 60
    for js, ts in zip(jplan.shards, tplan.shards):
        np.testing.assert_array_equal(js.order, ts.order)
        assert ts.fused == js.fused
        for jsch, tsch in zip(js.schedules, ts.schedules):
            for name in ("rows", "cols", "first", "last"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(jsch, name)),
                    getattr(tsch, name).numpy(), err_msg=name)
            jb = np.asarray(jsch.blocks)
            assert jb.tobytes() == \
                tsch.blocks.view(torch.uint16 if wdt == "bf16"
                                 else torch.float32).numpy().tobytes()
            if wdt == "f32":
                assert jsch.scales is None and tsch.scales is None
            else:
                np.testing.assert_array_equal(np.asarray(jsch.scales),
                                              tsch.scales.numpy())
    assert_arrays_equal(jplan.artifact_arrays(), tplan.artifact_arrays())


@pytest.mark.parametrize("gate", (False, True), ids=["ungated", "gated"])
def test_sharded_io_report_equals_reference(make_stack, gate):
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128), density=0.4,
                               block=32))
    for mesh in MESHES:
        jplan, tplan = both(jl, mesh, gate=gate, activation="relu")
        report = tplan.io_report()
        assert isinstance(report, ShardedIOReport)
        assert report.to_dict() == jplan.io_report().to_dict()
        assert ShardedIOReport.from_dict(report.to_dict()) == report
        assert report.summary() == jplan.io_report().summary()
        assert report.load_imbalance == jplan.io_report().load_imbalance
        assert report.weight_stream_bytes == \
            jplan.io_report().weight_stream_bytes
    assert ShardedIOReport(per_shard=()).load_imbalance == 1.0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_artifact_arrays_equal_reference(make_stack, mesh):
    jl = make_stack(sizes=(128, 256, 128), density=0.4, block=32)
    jplan, tplan = both(jl, mesh, weight_dtype="fp8", gate=True)
    assert_arrays_equal(jplan.artifact_arrays(), tplan.artifact_arrays())


# --------------------------------------------------------------------------- #
# outputs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", ("kernel", "torch"))
@pytest.mark.parametrize("gate", (False, True), ids=["ungated", "gated"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_outputs_match_reference(make_stack, mesh, gate, backend):
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128), density=0.4,
                               block=32))
    jplan, tplan = both(jl, mesh, backend=backend, gate=gate,
                        activation="relu")
    x = rows(7)
    x[:, :32] = 0.0                               # a dead input tile
    want = np.asarray(jplan(jnp.asarray(x)))
    y = tplan(x)
    assert y.shape == (7, 128) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(tplan(x[0]).numpy(), want[0], **TOL)
    np.testing.assert_allclose(tplan.plain()(x).numpy(), want, **TOL)
    # gating never changes a bit of the answer
    ungated = Engine(device="cpu", backend=backend,
                     activation="relu").compile(layers_from_numpy(jl),
                                                mesh=Mesh(*mesh))
    assert torch.equal(y, ungated(x))


def test_kernel_route_is_one_bsr_matmul_per_shard_and_layer(make_stack,
                                                            monkeypatch):
    """On ``kernel`` a model > 1 forward calls ``bsr_matmul`` once per shard
    and layer, each on that shard's own schedule, and nothing else of the
    kernels; a gated plan says that the route is ungated."""
    calls = []
    real = backends.bsr_matmul

    def counted(x, schedule, bias, activation="none"):
        calls.append(id(schedule))
        return real(x, schedule, bias, activation)

    def refuse(*_a, **_k):
        raise AssertionError("the megakernel ran on a sharded forward")

    monkeypatch.setattr(backends, "bsr_matmul", counted)
    monkeypatch.setattr(backends, "bsr_megakernel", refuse)
    jl = make_stack(sizes=(128, 256, 256, 128), density=0.4, block=32)
    for model, data in MESHES:
        plan = Engine(device="cpu", gate=True).compile(
            layers_from_numpy(jl), mesh=Mesh(model, data))
        calls.clear()
        plan(rows(5))
        assert sorted(calls) == sorted(id(s) for p in plan.shards
                                       for s in p.schedules)
        assert len(calls) == model * 3
        assert plan.fallback_reason == \
            "occupancy gating inactive on the layered pallas path"
        assert "kernel/bsr_matmul-per-shard+gated" in plan.describe()
        twin = plan.safe_twin()
        calls.clear()
        assert torch.equal(twin(rows(5)), plan(rows(5)))
        assert len(calls) == 2 * model * 3
        assert not twin.gate and twin.route == plan.route


# --------------------------------------------------------------------------- #
# bit-equal checks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", ("kernel", "torch"))
def test_unit_mesh_is_the_unsharded_forward(make_stack, backend):
    tl = layers_from_numpy(make_stack())
    engine = Engine(device="cpu", backend=backend, gate=True)
    plan = engine.compile(tl, mesh=Mesh(1, 1))
    assert len(plan.shards) == 1 and not plan.segments
    assert plan._forward is plan.shards[0]._forward
    base = engine.compile(tl)
    x = rows(6)
    assert torch.equal(plan(x), base(x))
    # Mesh(1, 2) pads the batch and runs the same forward
    two = engine.compile(tl, mesh=Mesh(1, 2))
    assert two._forward is two.shards[0]._forward
    assert torch.equal(two(x[:5]), base(x)[:5])
    assert engine.compile(tl, mesh=Mesh(1, 1)) is plan      # cached
    assert engine.compile(tl, mesh=Mesh(2, 1)) is not \
        engine.compile(tl, mesh=Mesh(4, 1))


@pytest.mark.parametrize("backend", ("kernel", "torch"))
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_padded_batch_rows_bit_equal(make_stack, mesh, backend):
    tl = layers_from_numpy(make_stack())
    plan = Engine(device="cpu", backend=backend, gate=True).compile(
        tl, mesh=Mesh(*mesh))
    x = rows(8)
    assert torch.equal(plan(x[:5]), plan(x)[:5])
    assert torch.equal(plan(x[:3]), plan(x)[:3])


def test_plan_api_contract(make_stack):
    tl = layers_from_numpy(make_stack())
    plan = Engine(device="cpu").compile(tl, mesh=Mesh(2, 2))
    assert (plan.n_in, plan.n_out, plan.n_layers) == (128, 128, 2)
    assert plan.dtype == torch.float32 and plan.device.type == "cpu"
    with pytest.raises(ValueError, match="expected input"):
        plan(np.zeros((2, 64), np.float32))
    with pytest.raises(RuntimeError, match="not standalone-runnable"):
        plan.shards[0](np.zeros((2, 128), np.float32))
    assert all(s._measure is None for s in plan.shards)
    s = plan.describe()
    assert "mesh(model=2, data=2)" in s and "imbalance" in s
    fresh = plan.with_fresh_forward()
    assert fresh.shards is plan.shards and fresh.calls == 0
    assert fresh._forward is not plan._forward
    x = rows(4)
    assert torch.equal(fresh(x), plan(x))
    assert plan.calls == 1 and fresh.calls == 1
    plain = plan.plain()
    assert plain.backend == "torch" and plain.route == "segment-per-shard"
    np.testing.assert_allclose(plain(x).numpy(), plan(x).numpy(), **TOL)


def test_torch_safe_twin_is_ungated_and_bit_equal(make_stack):
    jl = kill_tiles(make_stack(sizes=(128, 256, 256, 128)))
    tl = layers_from_numpy(jl)
    for mesh in ((1, 2), (2, 2)):
        plan = Engine(device="cpu", backend="torch", gate=True,
                      activation="relu").compile(tl, mesh=Mesh(*mesh))
        twin = plan.safe_twin()
        assert plan.gate and not twin.gate and twin.backend == "torch"
        x = rows(3)
        x[1] = 0.0
        assert torch.equal(twin(x), plan(x))
    # a one-shard twin lowers per layer, as ExecutionPlan.safe_twin
    assert twin.route == "segment-per-shard"
    one = Engine(device="cpu", gate=True).compile(tl, mesh=Mesh(1, 2))
    assert one.route == "fused" and one.safe_twin().route == "layered"


COLLECTIVE_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    rank, world, store, out, model, data = sys.argv[1:7]
    rank, world, model, data = int(rank), int(world), int(model), int(data)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.engine import Engine, Mesh
    from repro_torch.sparse import prune_dense_stack
    rng = np.random.default_rng(0)
    sizes = (128, 256, 256, 128)
    ws = [rng.standard_normal((sizes[i], sizes[i + 1])).astype(np.float32)
          * 0.1 for i in range(3)]
    bs = [rng.standard_normal(sizes[i + 1]).astype(np.float32) * 0.1
          for i in range(3)]
    layers = prune_dense_stack(ws, bs, density=0.4, block_m=32, block_n=32)
    x = np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32)
    x[:, :32] = 0.0
    result = {}
    for backend, gate in (("torch", False), ("torch", True),
                          ("kernel", False)):
        plan = Engine(device="cpu", backend=backend, gate=gate,
                      activation="relu").compile(layers,
                                                 mesh=Mesh(model, data))
        coll = plan.with_process_group(dist.group.WORLD)
        for B in (8, 5):
            result[f"{backend}-{gate}-{B}"] = bool(
                torch.equal(coll(x[:B]), plan(x[:B])))
        result[f"{backend}-{gate}-route"] = coll.route
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)
""")


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_collective_lowering_bit_equal_to_loop(tmp_path, mesh):
    """Four gloo processes, one per mesh slot, rendezvous through a file
    store; each answer equals the sequential shard loop's, bit for bit.
    The processes are joined against a deadline and killed on expiry."""
    world = mesh[0] * mesh[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "rendezvous")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", COLLECTIVE_RANK, str(r), str(world), store,
         outs[r], str(mesh[0]), str(mesh[1])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + COLLECTIVE_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            left = max(0.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the collective run did not end within "
                    f"{COLLECTIVE_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-3000:]
    for out in outs:
        with open(out) as f:
            result = json.load(f)
        assert result.pop("torch-False-route") == \
            "segment-per-shard+all_gather"
        assert result.pop("kernel-False-route") == \
            "bsr_matmul-per-shard+all_gather"
        assert result.pop("torch-True-route") == \
            "segment-per-shard+all_gather"
        assert result and all(result.values()), result


# --------------------------------------------------------------------------- #
# the plan store
# --------------------------------------------------------------------------- #

def store_engines(**kw):
    kw = dict(activation="relu", reorder=True, reorder_iters=30, **kw)
    return JaxEngine(backend="jnp", **kw), Engine(device="cpu", **kw)


def test_mesh_keys_equal_reference(make_stack):
    jl = make_stack()
    tl = layers_from_numpy(jl)
    seen = set()
    for gate in (False, True):
        je, te = store_engines(gate=gate, weight_dtype="bf16")
        for m, d in [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]:
            key = plan_cache_key(te, tl, mesh=Mesh(m, d))
            assert key == jax_key(je, jl, mesh=JaxMesh(m, d))
            seen.add(key)
        seen.add(plan_cache_key(te, tl))
    assert len(seen) == 12


@pytest.mark.parametrize("wdt", ("f32", "bf16", "fp8"))
def test_reference_sharded_entry_warm_starts_the_port(tmp_path, make_stack,
                                                      wdt):
    jl = make_stack(density=0.5)
    tl = layers_from_numpy(jl)
    je, te = store_engines(weight_dtype=wdt, gate=True)
    jplan, jhit = JaxStore(str(tmp_path)).get_or_compile(
        je, jl, mesh=JaxMesh(2, 2))
    assert not jhit and jplan.annealer_iters == 2 * 30
    store = PlanStore(str(tmp_path))
    assert store.contains(te, tl, mesh=Mesh(2, 2))
    plan, hit = store.get_or_compile(te, tl, mesh=Mesh(2, 2))
    assert hit and store.quarantined == 0
    assert [s.annealer_iters for s in plan.shards] == [0, 0]
    for js, ts in zip(jplan.shards, plan.shards):
        np.testing.assert_array_equal(js.order, ts.order)
    assert plan.io_report().to_dict() == jplan.io_report().to_dict()
    cold = store_engines(weight_dtype=wdt, gate=True)[1].compile(
        tl, mesh=Mesh(2, 2))
    x = rows(5)
    assert torch.equal(plan(x), cold(x))
    np.testing.assert_allclose(plan(x).numpy(), np.asarray(jplan(x)), **TOL)


@pytest.mark.parametrize("wdt", ("f32", "bf16", "fp8"))
def test_port_sharded_entry_warm_starts_the_reference(tmp_path, make_stack,
                                                      wdt):
    jl = make_stack(density=0.5)
    tl = layers_from_numpy(jl)
    je, te = store_engines(weight_dtype=wdt)
    tplan, thit = PlanStore(str(tmp_path)).get_or_compile(
        te, tl, mesh=Mesh(4, 1))
    assert not thit and tplan.annealer_iters == 4 * 30
    jstore = JaxStore(str(tmp_path))
    jplan, jhit = jstore.get_or_compile(je, jl, mesh=JaxMesh(4, 1))
    assert jhit and jplan.annealer_iters == 0 and jstore.quarantined == 0
    for js, ts in zip(jplan.shards, tplan.shards):
        np.testing.assert_array_equal(js.order, ts.order)


@pytest.mark.parametrize("wdt", ("f32", "bf16"))
def test_both_stores_write_the_same_sharded_bytes(tmp_path, make_stack, wdt):
    jl = make_stack(density=0.5)
    je, te = store_engines(weight_dtype=wdt)
    jstore = JaxStore(str(tmp_path / "jax"))
    tstore = PlanStore(str(tmp_path / "port"))
    jstore.get_or_compile(je, jl, mesh=JaxMesh(2, 1))
    tstore.get_or_compile(te, layers_from_numpy(jl), mesh=Mesh(2, 1))
    (key,) = tstore.keys()
    assert jstore.keys() == [key]
    jpath, tpath = jstore.path_for(key), tstore.path_for(key)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tman = json.load(f)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = json.load(f)
    assert tman["arrays"] == jman["arrays"]
    assert tman["extra"]["mesh"] == jman["extra"]["mesh"] == [2, 1]
    assert tman["extra"]["n_shards"] == jman["extra"]["n_shards"] == 2
    assert tman["extra"]["io"] == jman["extra"]["io"]
    names = sorted(os.listdir(tpath))
    assert names == sorted(os.listdir(jpath))
    assert {"assign_l0.npy", "assign_l1.npy", "s0_order.npy",
            "s1_order.npy"} <= set(names)
    assert ("s1_flat_qblocks.npy" in names) == (wdt != "f32")
    for name in names:
        if name.endswith(".npy"):
            with open(os.path.join(tpath, name), "rb") as a, \
                    open(os.path.join(jpath, name), "rb") as b:
                assert a.read() == b.read(), name


def test_corrupt_and_drifted_shard_entries_are_quarantined(tmp_path,
                                                           make_stack):
    tl = layers_from_numpy(make_stack())
    te = store_engines()[1]
    mesh = Mesh(2, 1)
    store = PlanStore(str(tmp_path))
    plan, _ = store.get_or_compile(te, tl, mesh=mesh)
    (key,) = store.keys()
    victim = os.path.join(store.path_for(key), "s1_order.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    assert store.load(te, tl, mesh=mesh) is None
    assert store.quarantined == 1 and store.keys() == []
    again, hit = store.get_or_compile(te, tl, mesh=mesh)
    assert not hit and again.annealer_iters == 2 * 30
    # a drifted shard array fails the verify; so does a drifted partition
    for name in ("s1_flat_rows", "assign_l0"):
        arrays = plan.artifact_arrays()
        arrays[name] = arrays[name][::-1].copy() if name == "s1_flat_rows" \
            else 1 - arrays[name]
        write_manifest_dir(
            store.path_for(key), arrays,
            {"format": 1, "io": plan.io_report().to_dict(), "mesh": [2, 1],
             "n_shards": 2}, dtypes=_artifact_dtypes(plan))
        assert store.load(te, tl, mesh=mesh) is None
    assert store.quarantined == 3
    qdir = tmp_path / "quarantine"
    reasons = sorted((qdir / e / "QUARANTINE_REASON.txt").read_text()
                     for e in os.listdir(qdir))
    assert reasons[0].startswith("load raised OSError: crc mismatch")
    assert reasons[1:] == ["self-heal verify failed: rebuilt shard arrays "
                           "!= stored arrays\n"] * 2


def test_sharded_store_misses_other_meshes(tmp_path, make_stack):
    tl = layers_from_numpy(make_stack())
    te = store_engines()[1]
    store = PlanStore(str(tmp_path))
    store.get_or_compile(te, tl, mesh=Mesh(2, 1))
    assert store.load(te, tl, mesh=Mesh(4, 1)) is None
    assert store.load(te, tl) is None
    assert store.load(te, tl, mesh=Mesh(2, 2)) is None
    assert store.load(te, tl, mesh=Mesh(2, 1)) is not None
    assert store.quarantined == 0
    assert store.evict(te, tl, mesh=Mesh(2, 1))
    assert not store.contains(te, tl, mesh=Mesh(2, 1))
    assert not store.evict(te, tl, mesh=Mesh(2, 1))


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #

def test_bucketed_plan_set_with_mesh(tmp_path, make_stack):
    tl = layers_from_numpy(make_stack())
    store = PlanStore(str(tmp_path))
    cold = BucketedPlanSet.compile(tl, engine=store_engines()[1],
                                   max_batch=8, plan_store=store,
                                   mesh=Mesh(4, 2), safe_twin=True).warmup()
    warm = BucketedPlanSet.compile(tl, engine=store_engines()[1],
                                   max_batch=8, plan_store=store,
                                   mesh=Mesh(4, 2))
    assert isinstance(cold.base, ShardedExecutionPlan)
    assert not cold.cache_hit and warm.cache_hit
    assert warm.base.annealer_iters == 0
    assert all(isinstance(p, ShardedExecutionPlan) for p in cold.plans.values())
    assert cold.safe.safe_mode and cold.safe.warmup_s
    assert cold.dtype == np.float32
    assert "mesh(model=4, data=2)" in cold.describe()
    x = rows(11)
    y = cold(x)                                   # 8 + 3 rows
    assert y.shape == (11, 128)
    np.testing.assert_array_equal(warm(x), y)
    np.testing.assert_array_equal(cold.safe(x), y)
    np.testing.assert_allclose(y, cold.base.plain()(x).numpy(), **TOL)


def test_server_with_mesh_serves_and_swaps(make_stack):
    old = layers_from_numpy(make_stack(seed=0))
    new = layers_from_numpy(make_stack(seed=1))
    engine = Engine(device="cpu", activation="relu", gate=True)
    mesh = Mesh(2, 2)
    plans = BucketedPlanSet.compile(old, engine=engine, max_batch=4,
                                    mesh=mesh).warmup()
    server = SparseServer(plans, engine=engine, mesh=mesh,
                          measure_dynamic_every=1)
    x = rows(10)
    rids = [server.submit(r) for r in x[:5]]
    server.poll()
    server.drain()
    before = np.stack([server.result(r) for r in rids])
    np.testing.assert_allclose(before, plans.base.plain()(x[:5]).numpy(),
                               **TOL)
    # a sharded plan has no measure_dynamic: the sampler stays inactive
    assert server.io.snapshot()["batches_measured"] == 0
    assert server.metrics.io_measure_failed == 0
    server.swap(new)
    assert server.plans is not plans
    assert server.plans.base.mesh == mesh
    rids = [server.submit(r) for r in x[5:]]
    server.drain()
    after = np.stack([server.result(r) for r in rids])
    np.testing.assert_allclose(
        after, server.plans.base.plain()(x[5:]).numpy(), **TOL)
    assert server.metrics.served == 10 and server.metrics.swaps == 1


def test_router_compiles_meshes_per_model(make_stack):
    nets = {"a": layers_from_numpy(make_stack(seed=0)),
            "b": layers_from_numpy(make_stack(seed=1))}
    router = ModelRouter.compile(nets, engine=Engine(device="cpu"),
                                 max_batch=4, meshes={"a": Mesh(4, 1)})
    assert router.servers["a"].plans.base.mesh == Mesh(4, 1)
    assert not isinstance(router.servers["b"].plans.base,
                          ShardedExecutionPlan)
    x = rows(12)
    rids = [(n, router.submit(n, r)) for i, r in enumerate(x)
            for n in ("ab"[i % 2],)]
    router.poll()
    router.drain()
    for i, (name, rid) in enumerate(rids):
        want = router.servers[name].plans.base.plain()(x[i]).numpy()
        np.testing.assert_allclose(router.result(name, rid), want, **TOL)


@pytest.mark.parametrize("extra", ([], ["--gate", "--async", "--workers",
                                         "2", "--models", "2"]),
                         ids=["step", "gated-async-router"])
def test_serve_cli_mesh_answers_every_request(extra):
    args = serve.parse_args(
        ["--sparse-ffnn", "--mesh", "4x2", "--device", "cpu",
         "--ffnn-sizes", "256", "1024", "256", "--block", "32",
         "--requests", "24", "--reorder-iters", "20", "--breaker", "2",
         *extra])
    report = serve.serve_sparse_ffnn(args)
    assert len(report.inputs) == 24
    assert all(y is not None for y in report.outputs.values())
    sets = serve._plan_sets(report.server)
    assert all(p.base.mesh == Mesh(4, 2) for p in sets)
    for key, x in report.inputs.items():
        plans = sets[0] if len(sets) == 1 else \
            report.server.servers[key[0]].plans
        np.testing.assert_allclose(report.outputs[key],
                                   plans.base.plain()(x).numpy(), **TOL)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(2, 1), (4, 2)], ids=["2x1", "4x2"])
def test_cuda_sharded_forward_launches_bsr_matmul(make_stack, cuda_device,
                                                  mesh):
    """On the card a model > 1 forward makes exactly model x layers
    bsr_matmul launches and no megakernel, within 1e-4 of its plain
    version, with every shard schedule's arrival counters back at zero."""
    plan = Engine(device=cuda_device, activation="relu").compile(
        layers_from_numpy(make_stack()), mesh=Mesh(*mesh))
    x = torch.from_numpy(rows(5)).to(cuda_device)
    K.reset_launches()
    y = plan(x)
    torch.cuda.synchronize()
    assert (K.bsr_matmul.launches, K.bsr_megakernel.launches) == \
        (mesh[0] * 2, 0)
    assert not any(s.arrivals.any() for p in plan.shards
                   for s in p.schedules)
    np.testing.assert_allclose(y.cpu().numpy(),
                               plan.plain()(x).cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    K.reset_launches()
