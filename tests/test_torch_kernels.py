"""Kernel parity: the port's kernel wrappers against the Pallas kernels.

On the CPU each wrapper runs its plain version; the reference kernels run in
Pallas interpret mode through the reference's own dispatch (which pads the
batch to its sublane multiple), so odd batches work on both sides.

Tolerances (error = max |a - b| / (1 + |b|)): f32 outputs 1e-5 (both sides
accumulate in f32, in different orders); bf16 outputs 3e-2 (one bf16 ulp of
rounding apart), as the reference's kernel tests.  Quantized weights
dequantize to identical f32 values on both sides, so they keep the f32/bf16
output tolerance.

Tests that need the card are marked ``cuda`` and skip without one.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import backends as jbackends
from repro.kernels import ops as jops
from repro_torch.convert import layers_from_numpy
from repro_torch.kernels import bsr_matmul as K
from repro_torch.kernels import ops as tops

JAX_ACT = {"relu": jax.nn.relu, "gelu": jax.nn.gelu, "sigmoid": jax.nn.sigmoid,
           "none": None}
TOL = {"f32": 1e-5, "bf16": 3e-2}


def err(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def port_out(y: torch.Tensor) -> np.ndarray:
    return y.float().numpy()


# (sizes, block, density, x dtype, weight dtype, batch, activation)
LAYER_CASES = [
    ((128, 192), (32, 64), 0.5, "f32", "f32", 3, "relu"),
    ((128, 128), (64, 32), 0.4, "bf16", "f32", 5, "gelu"),
    ((96, 128), (32, 32), 0.3, "f32", "bf16", 1, "sigmoid"),
    ((128, 96), (32, 32), 0.5, "f32", "fp8", 7, "gelu"),
    ((64, 128), (32, 32), 0.1, "bf16", "fp8", 2, "relu"),
]


@pytest.mark.parametrize("sizes,block,density,xdt,wdt,batch,act", LAYER_CASES)
def test_bsr_matmul_plain_matches_pallas(sizes, block, density, xdt, wdt,
                                         batch, act):
    from repro.core.blocksparse import to_bsr

    rng = np.random.default_rng(sum(sizes) + batch)
    w = rng.standard_normal(sizes).astype(np.float32) * 0.1
    b = rng.standard_normal(sizes[1]).astype(np.float32) * 0.1
    jl = to_bsr(w, *block, density=density, bias=b)
    tl = layers_from_numpy([jl])[0]
    perm = np.lexsort((jl.rows, jl.cols))
    jsch = jops.compile_schedule(jl, perm, wdt)
    tsch = tops.compile_schedule(tl, perm, wdt)
    x = rng.standard_normal((batch, sizes[0])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16"
                                else torch.float32)
    fwd = jbackends.make_forward([jl], [jsch], [JAX_ACT[act]], "interpret")
    y_ref = np.asarray(fwd(jx).astype(jnp.float32))
    y = K.bsr_matmul(tx, tsch, torch.from_numpy(tl.bias), act)
    assert y.dtype == tx.dtype and y.shape == (batch, sizes[1])
    assert err(port_out(y), y_ref) < TOL[xdt]
    assert K.bsr_matmul.launches == 0      # the plain version ran


def split_emulate(x: torch.Tensor, sch, bias: torch.Tensor, act, live=None,
                  out_dtype=None) -> torch.Tensor:
    """The split-K walk of both kernels on the CPU: one f32 partial per
    (step, K-slice), each run's partials summed in schedule order, then
    K-slice order, then bias and epilogue.  ``live`` (one bool per input
    tile) makes it gated: a step on a dead tile computes no product and
    writes a zero partial, as the gated megakernel does.  The output is
    stored in ``out_dtype`` (default ``x.dtype``)."""
    split = sch.split
    B = x.shape[0]
    _, bm, bn = sch.blocks.shape
    w = K._dequant(sch.blocks, sch.scales)
    xf = x.float()
    rows, cols = sch.rows.tolist(), sch.cols.tolist()
    run_ptr = sch.run_ptr.tolist()
    part_off = split.part_off.tolist()
    parts = torch.empty((split.n_parts, B, bn))
    for g, r in enumerate(rows):
        if live is not None and not live[r]:
            parts[part_off[g]:part_off[g] + split.n_slices] = 0.0
            continue
        for s in range(split.n_slices):
            k0 = s * split.k_slice
            k1 = min(bm, k0 + split.k_slice)
            parts[part_off[g] + s] = xf[:, r * bm + k0:r * bm + k1] @ w[g, k0:k1]
    out = torch.empty((B, sch.grid_out * bn), dtype=out_dtype or x.dtype)
    for g0, g1 in zip(run_ptr[:-1], run_ptr[1:]):
        acc = torch.zeros((B, bn))
        for g in range(g0, g1):
            for s in range(split.n_slices):
                acc = acc + parts[part_off[g] + s]
        c = cols[g0]
        y = K.apply_activation(acc + bias[c * bn:(c + 1) * bn], act)
        out[:, c * bn:(c + 1) * bn] = y.to(out.dtype)
    return out


def layer_runs(flat):
    """The index in ``run_ptr`` of every layer's first run, then the run
    count (every layer segment starts a run)."""
    starts = [s for s, _ in flat.segments] + [flat.nnz]
    return np.searchsorted(flat.run_ptr.numpy(), starts).tolist()


def flat_layer(flat, k):
    """Layer ``k`` of a flat schedule in the fields ``split_emulate`` reads:
    its steps, its runs and its share of the flat split plan, renumbered
    from the layer's first step."""
    s, e = flat.segments[k]
    lr = layer_runs(flat)
    split = dataclasses.replace(
        flat.split, step_run=flat.split.step_run[s:e] - lr[k],
        part_off=flat.split.part_off[s:e] - flat.split.part_off[s])
    return SimpleNamespace(
        split=split, blocks=flat.blocks[s:e], rows=flat.rows[s:e],
        cols=flat.cols[s:e], run_ptr=flat.run_ptr[lr[k]:lr[k + 1] + 1] - s,
        scales=None if flat.scales is None else flat.scales[s:e],
        grid_out=lr[k + 1] - lr[k])


def mega_emulate(x: torch.Tensor, flat, act, final_act, gate=False):
    """The megakernel's decomposition on the CPU: ``split_emulate`` chained
    over the flat segments, hidden tiles kept in f32.  With ``gate`` a step
    on a dead input tile computes nothing and contributes a zero partial
    (layer 0's liveness from ``tile_occupancy`` of x, later layers' from
    the slots), each hidden
    tile's live rows are counted per 32-row chunk into the kernel's slots,
    and the result is ``(y, slots)``: slots[k] is [grid_out_k, chunks]."""
    from repro_torch.engine import tile_occupancy

    B = x.shape[0]
    bs = flat.block
    chunks = -(-B // 32)
    lr = layer_runs(flat)
    h, slots = x, []
    for k in range(flat.n_layers):
        final = k == flat.n_layers - 1
        live = None
        if gate:
            live = (tile_occupancy(h, bs, h.shape[1] // bs) > 0).tolist() \
                if k == 0 else (slots[-1] > 0).any(dim=1).tolist()
        h = split_emulate(h, flat_layer(flat, k),
                          flat.bias_tiles[lr[k]:lr[k + 1]].reshape(-1),
                          final_act if final else act, live,
                          x.dtype if final else torch.float32)
        if gate and not final:
            nz = (h.reshape(B, -1, bs) != 0).any(dim=2)          # [B, tiles]
            nz = torch.cat([nz, nz.new_zeros((chunks * 32 - B, nz.shape[1]))])
            slots.append(nz.reshape(chunks, 32, -1).sum(dim=1).T.int())
    return (h, slots) if gate else h


def _layer_schedules(sizes, block, density, wdt, seed):
    from repro.core.blocksparse import to_bsr

    rng = np.random.default_rng(seed)
    w = rng.standard_normal(sizes).astype(np.float32) * 0.1
    b = rng.standard_normal(sizes[1]).astype(np.float32) * 0.1
    jl = to_bsr(w, *block, density=density, bias=b)
    tl = layers_from_numpy([jl])[0]
    perm = np.lexsort((jl.rows, jl.cols))
    return (jl, jops.compile_schedule(jl, perm, wdt),
            tl, tops.compile_schedule(tl, perm, wdt), rng)


@pytest.mark.parametrize("sizes,block,density,xdt,wdt,batch,act", LAYER_CASES
                         + [((256, 384), (128, 128), 0.3, "f32", "f32", 4,
                             "gelu"),
                            ((256, 256), (128, 128), 0.3, "f32", "fp8", 33,
                             "none")])
def test_bsr_matmul_split_plan_covers_every_step_once(sizes, block, density,
                                                      xdt, wdt, batch, act):
    """step -> run, K-slices and partial offsets: every step in exactly one
    run, every (step, slice) partial written once, every block row in one
    slice, and partials laid out (so reduced) in schedule order."""
    _, _, _, sch, _ = _layer_schedules(sizes, block, density, wdt, batch)
    split = sch.split
    bm, bn = block
    run_ptr = sch.run_ptr.numpy()
    step_run = sch.split_index[0].numpy()
    part_off = sch.split_index[1].numpy()
    np.testing.assert_array_equal(step_run, split.step_run)
    np.testing.assert_array_equal(part_off, split.part_off)
    n_steps = len(sch.rows)
    assert len(step_run) == n_steps and run_ptr[-1] == n_steps
    for run in range(len(run_ptr) - 1):
        assert (step_run[run_ptr[run]:run_ptr[run + 1]] == run).all()
    owners = np.zeros(split.n_parts, dtype=int)
    for g in range(n_steps):
        owners[part_off[g]:part_off[g] + split.n_slices] += 1
    assert (owners == 1).all()
    assert (np.diff(part_off) > 0).all()          # schedule order
    assert (split.n_slices - 1) * split.k_slice < bm <= \
        split.n_slices * split.k_slice
    itemsize = sch.blocks.element_size()
    assert split.vec in (1, 16 // itemsize)
    assert split.vec == 1 or (bn * itemsize) % 16 == 0
    # every thread's weight vectors fit its registers (kMaxVec = 8)
    groups = bn // split.vec
    assert groups <= 128 and -(-split.k_slice // (128 // groups)) <= 8
    assert sch.arrivals.numel() == sch.grid_out and \
        not sch.arrivals.any()


@pytest.mark.parametrize("sizes,block,density,xdt,wdt,batch,act", LAYER_CASES)
def test_bsr_matmul_split_emulation_matches_pallas(sizes, block, density, xdt,
                                                   wdt, batch, act):
    """The kernel's split-K decomposition, emulated on the CPU in its
    reduction order, against the reference's Pallas kernel (interpret)."""
    jl, jsch, tl, tsch, rng = _layer_schedules(sizes, block, density, wdt,
                                               sum(sizes) + batch)
    x = rng.standard_normal((batch, sizes[0])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16"
                                else torch.float32)
    fwd = jbackends.make_forward([jl], [jsch], [JAX_ACT[act]], "interpret")
    y_ref = np.asarray(fwd(jx).astype(jnp.float32))
    y = split_emulate(tx, tsch, torch.from_numpy(tl.bias), act)
    assert y.dtype == tx.dtype and y.shape == (batch, sizes[1])
    assert err(port_out(y), y_ref) < TOL[xdt]


def flat_schedules(jls, wdt):
    """The reference's and the port's flat schedules of one layer stack,
    in the same (output-tile grouped) order."""
    tls = layers_from_numpy(jls)
    jschs, tschs = [], []
    for jl, tl in zip(jls, tls):
        perm = np.lexsort((jl.rows, jl.cols))
        jschs.append(jops.compile_schedule(jl, perm, wdt))
        tschs.append(tops.compile_schedule(tl, perm, wdt))
    return (jops.compile_flat_schedule(jls, jschs),
            tops.compile_flat_schedule(tls, tschs))


MEGA_CASES = [
    ((96, 128, 64), 0.4, "f32", "f32", 3, "relu"),
    ((64, 128, 96, 64), 0.3, "f32", "bf16", 5, "gelu"),
    ((128, 64, 96), 0.5, "bf16", "fp8", 2, "sigmoid"),
]


@pytest.mark.parametrize("sizes,density,xdt,wdt,batch,act", MEGA_CASES)
def test_bsr_megakernel_plain_matches_pallas(make_stack, sizes, density, xdt,
                                             wdt, batch, act):
    jls = make_stack(sizes=sizes, density=density, block=32, seed=batch)
    jflat, tflat = flat_schedules(jls, wdt)
    acts = [JAX_ACT[act]] * (len(jls) - 1) + [None]
    fwd = jbackends.make_fused_forward(jls, jflat, acts, "interpret")
    x = np.random.default_rng(batch).standard_normal(
        (batch, sizes[0])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16"
                                else torch.float32)
    y_ref = np.asarray(fwd(jx).astype(jnp.float32))
    y = K.bsr_megakernel(tx, tflat, act, "none")
    assert y.dtype == tx.dtype and y.shape == (batch, sizes[-1])
    assert err(port_out(y), y_ref) < TOL[xdt]
    assert K.bsr_megakernel.launches == 0


# the megakernel cases, and one at batch 33, which spans two row chunks
FLAT_CASES = MEGA_CASES + [((96, 128, 64), 0.4, "f32", "f32", 33, "relu")]


def mega_item(seg0, steps, n_slices, it):
    """The megakernel's item ``it`` of a layer whose steps start at
    ``seg0``: (flat step, K-slice, row chunk), chunk-major."""
    chunk, q = divmod(it, steps * n_slices)
    return seg0 + q // n_slices, q % n_slices, chunk


@pytest.mark.parametrize("sizes,density,xdt,wdt,batch,act", FLAT_CASES)
def test_flat_split_plan_covers_every_step_once(make_stack, sizes, density,
                                                xdt, wdt, batch, act):
    """The megakernel's work items: every flat step in one run, every
    (step, slice) partial written once, each run's partials contiguous in
    schedule order then K-slice order, each layer's items inside its
    segment and its runs, and the arrival counters zero."""
    _, flat = flat_schedules(make_stack(sizes=sizes, density=density,
                                        block=32, seed=batch), wdt)
    split = flat.split
    run_ptr = flat.run_ptr.numpy()
    lr = layer_runs(flat)
    step_run, part_off = flat.split_index.numpy()
    np.testing.assert_array_equal(step_run, split.step_run)
    np.testing.assert_array_equal(part_off, split.part_off)
    n_steps = flat.nnz
    assert len(step_run) == n_steps and run_ptr[-1] == n_steps
    owners = np.zeros(split.n_parts, dtype=int)
    for g in range(n_steps):
        owners[part_off[g]:part_off[g] + split.n_slices] += 1
    assert (owners == 1).all()
    for run in range(len(run_ptr) - 1):
        g0, g1 = run_ptr[run], run_ptr[run + 1]
        assert (step_run[g0:g1] == run).all()
        np.testing.assert_array_equal(
            part_off[g0:g1], part_off[g0] + split.n_slices * np.arange(g1 - g0))
    chunks = -(-batch // 32)
    items = []
    for k, (s, e) in enumerate(flat.segments):
        assert run_ptr[lr[k]] == s and run_ptr[lr[k + 1]] == e
        layer_items = [mega_item(s, e - s, split.n_slices, it)
                       for it in range((e - s) * split.n_slices * chunks)]
        for g, _, _ in layer_items:
            assert s <= g < e
            assert lr[k] <= step_run[g] < lr[k + 1]
        items += layer_items
    assert sorted(items) == [(g, sl, c) for g in range(n_steps)
                             for sl in range(split.n_slices)
                             for c in range(chunks)]
    assert flat.max_layer_steps == max(e - s for s, e in flat.segments)
    assert (split.n_slices - 1) * split.k_slice < flat.block <= \
        split.n_slices * split.k_slice
    assert flat.arrivals.numel() == len(run_ptr) - 1 and \
        not flat.arrivals.any()


@pytest.mark.parametrize("sizes,density,xdt,wdt,batch,act", FLAT_CASES)
def test_megakernel_split_emulation_matches_pallas(make_stack, sizes, density,
                                                   xdt, wdt, batch, act):
    """The megakernel's decomposition, emulated on the CPU in its reduction
    order with f32 hidden tiles, against the reference's Pallas megakernel
    (interpret)."""
    jls = make_stack(sizes=sizes, density=density, block=32, seed=batch)
    jflat, tflat = flat_schedules(jls, wdt)
    acts = [JAX_ACT[act]] * (len(jls) - 1) + [None]
    fwd = jbackends.make_fused_forward(jls, jflat, acts, "interpret")
    x = np.random.default_rng(batch).standard_normal(
        (batch, sizes[0])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16"
                                else torch.float32)
    y_ref = np.asarray(fwd(jx).astype(jnp.float32))
    y = mega_emulate(tx, tflat, act, "none")
    assert y.dtype == tx.dtype and y.shape == (batch, sizes[-1])
    assert err(port_out(y), y_ref) < TOL[xdt]


@pytest.mark.parametrize("act", ["relu", "none"])
def test_plain_kernel_matches_dense_oracle(make_stack, act):
    """The port's own dense oracle agrees with the per-layer walk."""
    from repro_torch.kernels.ref import bsr_matmul_ref

    tl = layers_from_numpy(make_stack(sizes=(128, 96), density=0.3,
                                      block=32))[0]
    sch = tops.compile_schedule(tl, np.lexsort((tl.rows, tl.cols)))
    x = torch.randn((3, 128), generator=torch.Generator().manual_seed(1))
    bias = torch.from_numpy(tl.bias)
    want = bsr_matmul_ref(x, tl.rows, tl.cols, torch.from_numpy(tl.blocks),
                          bias, tl.grid_in, tl.grid_out, act)
    assert err(K.bsr_matmul(x, sch, bias, act).numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("name", sorted(K.ACTIVATIONS))
def test_activation_table_matches_reference(name):
    """Each epilogue equals the reference's (gelu is the tanh form)."""
    from repro.engine.engine import ACTIVATIONS as JAX_ACTIVATIONS

    y = np.linspace(-6, 6, 97, dtype=np.float32)
    ref = JAX_ACTIVATIONS[None if name == "none" else name]
    want = y if ref is None else np.asarray(ref(jnp.asarray(y)))
    got = K.apply_activation(torch.from_numpy(y), name).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_kernel_codes_reject_callables_and_unknown_names():
    assert K.activation_code(None) == K.activation_code("none") == 0
    with pytest.raises(ValueError, match="by name"):
        K.activation_code(torch.relu)
    with pytest.raises(ValueError, match="unknown activation"):
        K.activation_code("swish")


def test_wrapper_rejects_non_cuda_non_cpu_tensor(make_stack):
    tl = layers_from_numpy(make_stack(sizes=(64, 64), block=32))[0]
    sch = tops.compile_schedule(tl, np.lexsort((tl.rows, tl.cols)))
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        K.bsr_matmul(x, sch, torch.from_numpy(tl.bias))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (1, 5, 33))
@pytest.mark.parametrize("wdt", ("f32", "bf16", "fp8"))
def test_cuda_kernels_match_plain(make_stack, cuda_device, wdt, batch):
    """Both kernels on the card against their plain versions, odd batches
    (33 spans two of bsr_matmul's 32-row chunks)."""
    tls = layers_from_numpy(make_stack(sizes=(128, 256, 128), block=32))
    schs = [tops.compile_schedule(l, np.lexsort((l.rows, l.cols)), wdt,
                                  device=cuda_device) for l in tls]
    flat = tops.compile_flat_schedule(tls, schs)
    x = torch.randn((batch, 128), generator=torch.Generator().manual_seed(0))
    x = x.to(cuda_device)
    K.reset_launches()
    y = K.bsr_megakernel(x, flat, "gelu", "none")
    y_ref = K.bsr_megakernel_plain(x, flat, "gelu", "none")
    assert err(y.cpu(), y_ref.cpu()) < 1e-4
    assert not flat.arrivals.any()
    biases = [torch.from_numpy(l.bias).to(cuda_device) for l in tls]
    # one split-K walk: with f32 x, bit-equal to two bsr_matmul launches
    h = K.bsr_matmul(x, schs[0], biases[0], "gelu")
    assert torch.equal(y, K.bsr_matmul(h, schs[1], biases[1], "none"))
    for _ in range(2):           # the arrival counters reset themselves
        y = K.bsr_matmul(x, schs[0], biases[0], "relu")
        y_ref = K.bsr_matmul_plain(x, schs[0], biases[0], "relu")
        assert err(y.cpu(), y_ref.cpu()) < 1e-4
    assert (K.bsr_matmul.launches, K.bsr_megakernel.launches) == (4, 1)
    assert not schs[0].arrivals.any()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (1, 33))
@pytest.mark.parametrize("sizes,block,density,xdt,wdt,_batch,act",
                         LAYER_CASES)
def test_cuda_bsr_matmul_ragged_blocks_match_plain(cuda_device, sizes, block,
                                                   density, xdt, wdt, _batch,
                                                   act, batch):
    """bsr_matmul on the card at the parity cases' block shapes (narrow,
    non-square, K-slices shorter than a block) against its plain version."""
    _, _, tl, _, rng = _layer_schedules(sizes, block, density, wdt, batch)
    sch = tops.compile_schedule(tl, np.lexsort((tl.rows, tl.cols)), wdt,
                                device=cuda_device)
    x = torch.from_numpy(rng.standard_normal((batch, sizes[0])).astype(
        np.float32)).to(cuda_device)
    x = x.to(torch.bfloat16 if xdt == "bf16" else torch.float32)
    bias = torch.from_numpy(tl.bias).to(cuda_device)
    y = K.bsr_matmul(x, sch, bias, act)
    y_ref = K.bsr_matmul_plain(x, sch, bias, act)
    assert err(y.float().cpu(), y_ref.float().cpu()) < \
        {"f32": 1e-4, "bf16": 3e-2}[xdt]
