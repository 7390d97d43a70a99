"""The gate/up pair layer (a SwiGLU FFN on the sparse engine) against its
plain reference (``glu_reference.py``), on the CPU.

A pruned 128 -> 512 -> 128 gated FFN in 32-wide blocks runs through
``Engine.compile`` on both backends, fused and layered, with and without
Connection Reordering; outputs agree with the reference within the port's
f32 ``rtol = atol = 1e-5``, a tolerance that a reference leaving out the
gate's product, or computing in TF32, fails.  Also: the pruning's pairs,
the I/O report's weight bytes, what such a net refuses, and the serving
runtime on it.
"""

import numpy as np
import pytest
import torch
from conftest import FakeClock
from glu_reference import GLUReference

from repro_torch.engine import Engine, Mesh
from repro_torch.kernels.ops import wide_schedule
from repro_torch.kernels.ref import bsr_to_dense
from repro_torch.serving import BucketedPlanSet, SparseServer
from repro_torch.sparse import GLULayer, pair_mask, prune_glu_ffn

TOL = dict(rtol=1e-5, atol=1e-5)
N, F, BLOCK, DENSITY = 128, 512, 32, 0.3


def weights(seed=0, n=N, f=F, scale=0.15):
    rng = np.random.default_rng(seed)
    w = [rng.standard_normal(s).astype(np.float32) * scale
         for s in ((n, f), (n, f), (f, n))]
    b = [rng.standard_normal(m).astype(np.float32) * 0.1 for m in (f, f, n)]
    return w, b


@pytest.fixture(scope="module")
def net():
    (wg, wu, wd), (bg, bu, bd) = weights()
    layers = prune_glu_ffn(wg, wu, wd, DENSITY, BLOCK, b_gate=bg, b_up=bu,
                           b_down=bd)
    ref = GLUReference(wg, wu, wd, bg, bu, bd, BLOCK, DENSITY)
    x = np.random.default_rng(1).standard_normal((9, N)).astype(np.float32)
    return layers, ref, x


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_pair_net_matches_reference(net, backend, fuse, reorder):
    layers, ref, x = net
    plan = Engine(device="cpu", backend=backend, activation="silu",
                  fuse=fuse, reorder=reorder, reorder_iters=100,
                  seed=2).compile(layers)
    assert plan.fused == fuse
    y = plan(x).numpy()
    want = ref(x).numpy()
    np.testing.assert_allclose(y, want, **TOL)
    assert np.abs(want).max() > 0.5
    # what the tolerance must catch: the gate's product left out, TF32
    skipped = GLUReference(*weights()[0], *weights()[1], BLOCK, DENSITY,
                           skip_gate=True)(x).numpy()
    assert not np.allclose(y, skipped, **TOL)
    assert not np.allclose(y, ref(x, "tf32").numpy(), **TOL)
    # the safe twin and the plain version answer alike
    np.testing.assert_allclose(plan.safe_twin()(x).numpy(), want, **TOL)
    np.testing.assert_allclose(plan.plain()(x).numpy(), want, **TOL)


def test_pruning_keeps_the_top_pairs_by_joint_norm():
    """The kept pairs are the round(density * blocks) of largest
    sqrt(|G|^2 + |U|^2), which neither matrix's own norms would pick."""
    rng = np.random.default_rng(3)
    wg = rng.standard_normal((64, 128)).astype(np.float32) * 0.01
    wu = rng.standard_normal((64, 128)).astype(np.float32) * 0.01
    blk = lambda w, i, j: w[32 * i:32 * (i + 1), 32 * j:32 * (j + 1)]
    blk(wg, 0, 1)[:] += 3.0          # big in the gate alone
    blk(wu, 1, 2)[:] += 3.0          # big in up alone
    blk(wg, 1, 0)[:] += 2.5          # big in both, less than 3 in each ...
    blk(wu, 1, 0)[:] += 2.5          # ... more than 3 together
    blk(wg, 0, 3)[:] += 1.0
    mask = pair_mask(wg, wu, 32, 3 / 8)
    assert sorted(zip(*np.nonzero(mask))) == [(0, 1), (1, 0), (1, 2)]
    wd = rng.standard_normal((128, 64)).astype(np.float32)
    pair, down = prune_glu_ffn(wg, wu, wd, 3 / 8, 32)
    assert sorted(zip(pair.rows.tolist(), pair.cols.tolist())) == \
        [(0, 1), (1, 0), (1, 2)]
    for i, (r, c) in enumerate(zip(pair.rows, pair.cols)):
        np.testing.assert_array_equal(pair.blocks[i, :, :32], blk(wg, r, c))
        np.testing.assert_array_equal(pair.blocks[i, :, 32:], blk(wu, r, c))
    assert down.nnz_blocks == 3 and not np.any(pair.bias)
    # the layered path's [gate | up] layer, built from the compiled pair
    # schedule (3 pairs and output tile 3's patch step, in each half)
    plan = Engine(device="cpu", activation="silu", fuse=False,
                  reorder=True, reorder_iters=50).compile([pair, down])
    sch = plan.schedules[0]
    wide = wide_schedule(sch, 64)
    assert sch.wide is wide and wide.grid_out == 8 and len(wide.rows) == 8
    keep = np.kron(mask, np.ones((32, 32), np.float32))
    np.testing.assert_array_equal(
        bsr_to_dense(wide.rows, wide.cols, wide.blocks, 2, 8).numpy(),
        np.concatenate([wg * keep, wu * keep], axis=1))


def test_io_report_counts_two_blocks_a_pair():
    """64 -> 128 -> 64 in 32-wide blocks, 4 of 8 pairs and 4 of 8 down
    blocks kept, every output tile covered (no patch block): the weight
    stream is 2 x 4 + 4 = 12 blocks of 32 x 32 f32, fused or layered."""
    rng = np.random.default_rng(4)
    small = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.01
    wg, wu, wd = small(64, 128), small(64, 128), small(128, 64)
    for i, j in ((0, 0), (1, 1), (0, 2), (1, 3)):
        wg[32 * i:32 * (i + 1), 32 * j:32 * (j + 1)] += 1.0
    for i, j in ((0, 0), (1, 1), (2, 0), (3, 1)):
        wd[32 * i:32 * (i + 1), 32 * j:32 * (j + 1)] += 1.0
    layers = prune_glu_ffn(wg, wu, wd, 0.5, 32)
    for fuse in (True, False):
        plan = Engine(device="cpu", activation="silu",
                      fuse=fuse).compile(layers)
        assert plan.io.weight_bytes_streamed == 12 * 32 * 32 * 4
        assert plan.schedules[0].n_patch == plan.schedules[1].n_patch == 0


@pytest.mark.parametrize("kw,match", [
    (dict(gate=True), "gate=True"),
    (dict(weight_dtype="bf16"), "weight_dtype='bf16'"),
    (dict(weight_dtype="fp8"), "weight_dtype='fp8'"),
])
def test_pair_net_refuses_what_it_cannot_run(net, kw, match):
    layers = net[0]
    with pytest.raises(ValueError, match=match):
        Engine(device="cpu", activation="silu", **kw).compile(layers)


def test_pair_net_refuses_a_mesh_and_narrow_x(net):
    layers, _, x = net
    engine = Engine(device="cpu", activation="silu")
    with pytest.raises(ValueError, match="a mesh"):
        engine.compile(layers, mesh=Mesh(model=2, data=1))
    plan = engine.compile(layers)
    for p in (plan, plan.safe_twin(), plan.plain()):
        with pytest.raises(ValueError, match="float32 x"):
            p(torch.from_numpy(x).to(torch.bfloat16))
    # weights that are not float32 are refused at compile
    pair = layers[0]
    f64 = GLULayer(n_in=pair.n_in, n_out=pair.n_out, block_m=pair.block_m,
                   block_n=pair.block_n, rows=pair.rows, cols=pair.cols,
                   blocks=pair.blocks.astype(np.float64), bias=pair.bias)
    with pytest.raises(ValueError, match="float64"):
        engine.compile([f64, layers[1]])


def test_sparse_server_serves_a_pair_net(net):
    """A step-driven ``SparseServer`` over a ``BucketedPlanSet`` of the
    pair net: every answer within the f32 tolerance of the reference."""
    layers, ref, _ = net
    plans = BucketedPlanSet.compile(
        layers, engine=Engine(device="cpu", activation="silu", reorder=True,
                              reorder_iters=50), max_batch=4).warmup()
    assert plans.base.fused
    server = SparseServer(plans, clock=FakeClock())
    rows = np.random.default_rng(5).standard_normal((11, N)).astype(
        np.float32)
    rids = []
    for i, x in enumerate(rows):
        rids.append(server.submit(x))
        if i % 3 == 2:
            server.poll()
    server.drain()
    for rid, x in zip(rids, rows):
        y = server.result(rid)
        assert y is not None and y.shape == (N,)
        np.testing.assert_allclose(y, ref(x[None])[0].numpy(), **TOL)
