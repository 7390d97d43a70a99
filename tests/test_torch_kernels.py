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

import ctypes
import dataclasses
import sys
import threading
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


class FakeLib:
    """Stands in for the built library: records the walk of each launch
    block it packs (``packed``), and each megakernel launch's walk, epoch
    and per-call pointers (scratch, arrivals, slots); every call
    succeeds, a launch with a grid of 1."""

    def __init__(self):
        self.packed = []
        self.epochs = []
        self.walks = []
        self.calls = []
        self._walk = {}
        self._mu = threading.Lock()

    def bsr_megakernel_prepare(self, block, capacity, row_tiled, *args):
        with self._mu:
            walk = "row-tiled" if row_tiled else "split-K"
            self._walk[ctypes.addressof(block)] = walk
            self.packed.append(walk)
        return 0

    def bsr_megakernel_prepared_launch(self, block, x, out, scratch, B,
                                       stream, arrivals, occ0, slots, occ,
                                       epoch):
        with self._mu:
            walk = self._walk[block]
            if walk == "row-tiled" and occ is not None:
                walk += ", gated"
            self.epochs.append(epoch)
            self.walks.append(walk)
            self.calls.append(dict(B=B, scratch=scratch, arrivals=arrivals,
                                   slots=slots))
        return 1

    def bsr_matmul_launch(self, *args):
        return 0


def test_launch_bookkeeping_is_exact_under_threads(make_stack, monkeypatch):
    """16 threads launch one schedule's kernels through the wrappers'
    bookkeeping (a fake library stands in for the card): every gated
    launch draws its own epoch, never 0, and every count is exact."""
    tls = layers_from_numpy(make_stack(sizes=(64, 128, 64), block=32))
    schs = [tops.compile_schedule(l, np.lexsort((l.rows, l.cols)))
            for l in tls]
    flat = tops.compile_flat_schedule(tls, schs)
    lib = FakeLib()
    monkeypatch.setattr(K._build, "load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda index: 0)
    x = torch.zeros((5, 64))
    occ0 = torch.zeros(2, dtype=torch.int32)
    bias = torch.from_numpy(tls[0].bias)
    threads_n, per_thread = 16, 25

    def work():
        for _ in range(per_thread):
            occ = torch.empty((1, flat.hidden_tiles), dtype=torch.int32)
            K._launch_megakernel(x, flat, 0, 0, occ0, occ,
                                 torch.empty((5, 64)))
            K._launch_megakernel(x, flat, 0, 0, None, None,
                                 torch.empty((5, 64)))
            K._launch_matmul(x, schs[0], bias, 0, torch.empty((5, 128)))

    K.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = threads_n * per_thread
    gated = sorted(e for e in lib.epochs if e)
    assert gated == list(range(1, n + 1))       # distinct tags, never 0
    assert lib.epochs.count(0) == n             # the ungated launches
    assert (K.bsr_megakernel.gated_launches, K.bsr_megakernel.launches,
            K.bsr_matmul.launches) == (n, n, n)
    flat.epoch = 0xFFFFFFFF                     # the tag wraps past 0
    assert K.next_epoch(flat) == 1
    K.reset_launches()


def test_schedule_launches_stay_on_one_stream(make_stack, monkeypatch):
    tl = layers_from_numpy(make_stack(sizes=(64, 64), block=32))[0]
    sch = tops.compile_schedule(tl, np.lexsort((tl.rows, tl.cols)))
    flat = tops.compile_flat_schedule([tl], [sch])
    monkeypatch.setattr(K._build, "load", lambda: FakeLib())
    x, bias = torch.zeros((2, 64)), torch.from_numpy(tl.bias)
    monkeypatch.setattr(K, "_stream", lambda index: 7)
    K._launch_matmul(x, sch, bias, 0, torch.empty((2, 64)))
    K._launch_megakernel(x, flat, 0, 0, None, None, torch.empty((2, 64)))
    monkeypatch.setattr(K, "_stream", lambda index: 8)
    with pytest.raises(RuntimeError, match="stream 0x8"):
        K._launch_matmul(x, sch, bias, 0, torch.empty((2, 64)))
    with pytest.raises(RuntimeError, match="stream 0x8"):    # packed already
        K._launch_megakernel(x, flat, 0, 0, None, None, torch.empty((2, 64)))
    K.reset_launches()


def test_library_abi_and_build_key_match_the_sources():
    """The C entries defined across ``csrc/*.cu`` are exactly the ones
    ``_build`` binds, every ``.cu`` is built, and the headers that key the
    build are exactly the ones the sources include: a header missing from
    ``HEADERS`` would leave a stale build under the same hash."""
    import re

    from repro_torch.kernels import _build

    sources = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    headers = {p.name: p.read_text() for p in _build.CSRC.glob("*.cuh")}
    entries = {name for text in sources.values()
               for name in re.findall(r'extern "C" \w+ (\w+)\(', text)}
    assert entries == set(_build._SIGNATURES)
    assert set(sources) == {p.name for p in _build.SOURCES}
    included = {name for text in [*sources.values(), *headers.values()]
                for name in re.findall(r'#include "([^"]+)"', text)}
    assert included == {p.name for p in _build.HEADERS}


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


# --------------------------------------------------------------------------- #
# the megakernel's row-tiled route (large batches)
# --------------------------------------------------------------------------- #

# the benchmark's two nets (bench/configs): the BERT-large FFNN and the
# paper's five 512-wide layers, both at density 0.1
ROW_NETS = {"bert": ((1024, 4096, 1024), 128), "mlp": ((512,) * 5, 64)}


def row_layers(kind, dead_hidden=False, density=0.1):
    """The layers of one of ``ROW_NETS`` pruned to ``density``, with weights
    and biases of N(0, 0.03^2); ``dead_hidden`` sets every other hidden
    output tile's bias to -10, so that relu kills it."""
    from repro_torch.sparse import prune_dense_stack

    sizes, block = ROW_NETS[kind]
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal((a, b)).astype(np.float32) * 0.03
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.standard_normal(b).astype(np.float32) * 0.03
          for b in sizes[1:]]
    if dead_hidden:
        for b in bs[:-1]:
            b.reshape(-1, block)[::2] = -10.0
    return prune_dense_stack(ws, bs, density=density, block_m=block,
                             block_n=block)


def late_patch_layers():
    """512 -> 1024 -> 512 in 64-wide blocks, whose second layer keeps
    blocks in two of its eight output tiles only: at any B that takes the
    row-tiled walk, some CTA's first item of that layer is a patch item."""
    from repro_torch.sparse import prune_dense_stack

    rng = np.random.default_rng(2)
    ws = [rng.standard_normal((512, 1024)).astype(np.float32) * 0.03,
          rng.standard_normal((1024, 512)).astype(np.float32) * 0.03]
    ws[1][:, 128:] = 0.0
    bs = [rng.standard_normal(n).astype(np.float32) * 0.03
          for n in (1024, 512)]
    return prune_dense_stack(ws, bs, density=0.1, block_m=64, block_n=64)


def row_flat(layers, wdt="f32", device="cpu"):
    schs = [tops.compile_schedule(l, np.lexsort((l.rows, l.cols)), wdt,
                                  device=device) for l in layers]
    return tops.compile_flat_schedule(layers, schs)


def row_net(kind, wdt="f32", device="cpu", dead_hidden=False):
    """A flat schedule of one of ``ROW_NETS`` (``row_layers``)."""
    return row_flat(row_layers(kind, dead_hidden), wdt, device)


def row_crossover(flat):
    """The least batch that takes the row-tiled walk."""
    return next(B for B in range(1, 1 << 13) if K.row_tiled(B, flat))


@pytest.mark.parametrize("B", (1, 5, 32, 4096))
@pytest.mark.parametrize("kind", sorted(ROW_NETS))
def test_row_tiled_route_rule(kind, B):
    """Serving batches take the split-K walk and 4,096-row calls the
    row-tiled one, whose scratch holds the hidden buffer and no partials;
    the deal lists each layer's runs once, longest first."""
    flat = row_net(kind)
    rows = K.row_tiled(B, flat)
    assert rows == (B > 32)
    hidden = 2 * flat.hidden_tiles * B * flat.block
    parts = flat.split.n_parts * B * flat.block
    assert K.megakernel_scratch_floats(B, flat, rows) == \
        hidden + (0 if rows else parts)
    runs = flat.row_runs
    run_ptr = flat.run_ptr.numpy()
    np.testing.assert_array_equal(flat.row_order.numpy(), runs.walk_order())
    for k, (s, e) in enumerate(flat.segments):
        layer = runs.order[runs.first[k]:runs.first[k + 1]]
        assert sorted(layer) == list(range(runs.first[k], runs.first[k + 1]))
        assert run_ptr[runs.first[k]] == s and \
            run_ptr[runs.first[k + 1]] == e
        live = runs.live[layer]
        assert list(live) == sorted(live, reverse=True)
        assert (live <= run_ptr[layer + 1] - run_ptr[layer]).all()


def row_deal(n_items, grid):
    """The items each CTA of ``grid`` takes, as the row-tiled walk deals
    them: forward in even rounds, backward in odd ones."""
    deal = [[] for _ in range(grid)]
    for i in range(n_items):
        rnd, j = divmod(i, grid)
        deal[j if rnd % 2 == 0 else grid - 1 - j].append(i)
    return deal


@pytest.mark.parametrize("B", (1025, 4096))
@pytest.mark.parametrize("kind", sorted(ROW_NETS))
def test_row_tiled_deal_covers_every_item_once(kind, B):
    """Every (run, row tile) of every layer is one CTA's, each CTA's items
    come longest first by live steps (a patch item has none), and the
    busiest CTA is within one longest item of the mean (2 CTAs on each of
    the H100's 132 SMs)."""
    flat = row_net(kind)
    nt = -(-B // K._ROW_BM)
    runs = flat.row_runs
    run_ptr = flat.run_ptr.numpy()
    n_items = [(b - a) * nt for a, b in zip(runs.first[:-1],
                                            runs.first[1:])]
    grid = min(2 * 132, max(n_items))
    for k in range(flat.n_layers):
        deal = row_deal(n_items[k], grid)
        seen = sorted(i for items in deal for i in items)
        assert seen == list(range(n_items[k]))
        item_run = runs.order[runs.first[k] + np.arange(n_items[k]) // nt]
        assert len({(int(r), i % nt) for i, r in enumerate(item_run)}) == \
            n_items[k]
        cost = runs.live[item_run]
        assert (cost <= run_ptr[item_run + 1] - run_ptr[item_run]).all()
        for mine in deal:
            assert list(cost[mine]) == sorted(cost[mine], reverse=True)
        busiest = max(cost[mine].sum() for mine in deal)
        assert busiest <= cost.sum() / grid + cost.max()


# nets whose schedules have patch runs: the benchmark's two, and one whose
# second layer starts some CTAs on a patch item
PATCH_NETS = {"bert": lambda: row_layers("bert"),
              "mlp": lambda: row_layers("mlp"),
              "late": late_patch_layers}


@pytest.mark.parametrize("net", sorted(PATCH_NETS))
def test_row_tiled_patch_runs_are_the_patched_tiles(net):
    """The runs with no live step are exactly the output tiles that
    ``compile_schedule`` patched, layer by layer: one zero block each,
    dealt after every run that keeps a block and flagged ``~run`` in the
    order the kernel reads."""
    layers = PATCH_NETS[net]()
    flat = row_flat(layers)
    runs = flat.row_runs
    run_ptr, cols = flat.run_ptr.numpy(), flat.cols.numpy()
    walk = flat.row_order.numpy()
    patched = 0
    for k, layer in enumerate(layers):
        a, b = runs.first[k], runs.first[k + 1]
        empty = sorted(set(range(layer.grid_out)) - set(layer.cols.tolist()))
        patch = [r for r in range(a, b) if runs.live[r] == 0]
        assert sorted(int(cols[run_ptr[r]]) for r in patch) == empty
        for r in patch:
            assert run_ptr[r + 1] - run_ptr[r] == 1
            assert not flat.blocks[run_ptr[r]].float().any()
        order = runs.order[a:b]
        assert sorted(order[b - a - len(patch):]) == patch
        np.testing.assert_array_equal(walk[a:b] < 0, np.isin(order, patch))
        np.testing.assert_array_equal(np.where(walk[a:b] < 0, ~walk[a:b],
                                               walk[a:b]), order)
        patched += len(empty)
    assert runs.patch_runs == patched > 0


def test_row_tiled_runs_without_an_empty_tile_have_no_patch_run():
    """A net whose every output tile keeps a block has no patch run: every
    step is live, and each layer's runs are dealt by their step counts,
    longest first, ties in schedule order, unflagged."""
    layers = row_layers("mlp", density=0.5)
    assert all(set(l.cols.tolist()) == set(range(l.grid_out))
               for l in layers)
    flat = row_flat(layers)
    runs = flat.row_runs
    steps = np.diff(flat.run_ptr.numpy())
    assert runs.patch_runs == 0
    np.testing.assert_array_equal(runs.live, steps)
    by_steps = np.concatenate([
        np.arange(a, b)[np.argsort(-steps[a:b], kind="stable")]
        for a, b in zip(runs.first[:-1], runs.first[1:])])
    np.testing.assert_array_equal(runs.order, by_steps)
    np.testing.assert_array_equal(flat.row_order.numpy(), by_steps)


def test_row_tiled_counts_its_patch_items(monkeypatch):
    """While tracing is active each row-tiled launch, gated or not, adds
    its patch items (patch runs, counted when its block was packed, x 64-row
    tiles) to ``mega.patch_items``, once; a split-K launch adds none."""
    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer

    flat = row_net("mlp")
    monkeypatch.setattr(K._build, "load", lambda: FakeLib())
    monkeypatch.setattr(K, "_stream", lambda index: 0)
    occ0 = torch.ones(8, dtype=torch.int32)
    before = trace.totals()["counters"].get("mega.patch_items", 0)
    tracer = Tracer()
    for B, gate in ((32, False), (4096, False), (65, True), (4096, True)):
        occ = torch.empty((3, 8), dtype=torch.int32) if gate else None
        with tracer.span(str(B)):
            K._launch_megakernel(torch.zeros((B, 512)), flat, 2, 0,
                                 occ0 if gate else None, occ,
                                 torch.empty((B, 512)))
    got = [sp.attrs.get("mega.patch_items", 0) for sp in tracer.spans()]
    assert flat.row_runs.patch_runs == 14
    assert [p.patch_runs for p in flat.launch_blocks.values()] == [0, 14]
    assert got == [0, 14 * 64, 14 * 2, 14 * 64]
    assert trace.totals()["counters"]["mega.patch_items"] == \
        before + sum(got)
    K.reset_launches()


def test_row_tiled_launch_bookkeeping(monkeypatch):
    """The wrapper on either walk (a fake library stands in for the card):
    a row-tiled launch goes to its own entry (gated or not) with a scratch
    sized without partials, leaves the arrival counters alone, and counts
    in ``row_tiled_launches`` beside ``launches`` or ``gated_launches``."""
    flat = row_net("mlp")
    lib = FakeLib()
    sized = []
    scratch = K.megakernel_scratch_floats

    def sizing(B, flat, rows):
        sized.append((B, rows))
        return scratch(B, flat, rows)

    monkeypatch.setattr(K._build, "load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda index: 0)
    monkeypatch.setattr(K, "megakernel_scratch_floats", sizing)
    K.reset_launches()
    arrivals = flat.arrivals
    occ0 = torch.ones(8, dtype=torch.int32)
    for B, gate in ((32, False), (4096, False), (4096, True)):
        x = torch.zeros((B, 512))
        occ = torch.empty((3, 8), dtype=torch.int32) if gate else None
        K._launch_megakernel(x, flat, 0, 0, occ0 if gate else None, occ,
                             torch.empty((B, 512)))
    assert lib.walks == ["split-K", "row-tiled", "row-tiled, gated"]
    assert lib.epochs == [0, 0, 1]
    assert sized == [(32, False), (4096, True), (4096, True)]
    assert flat.arrivals is arrivals
    assert (K.bsr_megakernel.launches, K.bsr_megakernel.row_tiled_launches,
            K.bsr_megakernel.gated_launches) == (2, 2, 1)
    K.reset_launches()
    assert K.bsr_megakernel.row_tiled_launches == 0


# the order of batches the prepared launch is run through: both walks,
# row chunks grown and shrunk, the largest call first at 4,096 rows
PREPARED_BATCHES = (1, 32, 33, 65, 4096, 33, 4096)


def test_megakernel_packs_its_launch_once_per_walk(monkeypatch):
    """The flat schedule's tensors are checked, and a launch block packed,
    once per walk, not per call; ``mega.pack`` counts the packing in a
    traced call and nothing while tracing is inactive.  A view of x that is
    not 16-byte aligned takes the split-K walk at any B."""
    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer

    flat = row_net("mlp")
    lib = FakeLib()
    checked = []
    check = K._check_flat

    def counting_check(device, flat):
        checked.append(device)
        check(device, flat)

    monkeypatch.setattr(K._build, "load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda index: 0)
    monkeypatch.setattr(K, "_check_flat", counting_check)
    occ0 = torch.ones(8, dtype=torch.int32)

    def launch(B, gate, x=None):
        x = torch.zeros((B, 512)) if x is None else x
        occ = torch.empty((3, 8), dtype=torch.int32) if gate else None
        K._launch_megakernel(x, flat, 2, 0, occ0 if gate else None, occ,
                             torch.empty((B, 512)))

    K.reset_launches()
    before = trace.totals()["counters"].get("mega.pack", 0)
    tracer = Tracer()
    with tracer.span("first"):
        launch(1, False)
    (span,) = tracer.spans()
    assert span.attrs["mega.pack"] == 1
    for i, B in enumerate(PREPARED_BATCHES):
        for gate in (i % 2 == 1, i % 2 == 0):
            launch(B, gate)
    assert trace.totals()["counters"].get("mega.pack", 0) == before + 1
    assert lib.packed == ["split-K", "row-tiled"]
    assert checked == [torch.device("cpu")] * 2
    assert lib.walks[1:5] == ["split-K"] * 4           # B = 1, 32
    assert lib.walks[-2:] == ["row-tiled", "row-tiled, gated"]
    n = 1 + 2 * len(PREPARED_BATCHES)
    assert K.bsr_megakernel.launches + K.bsr_megakernel.gated_launches == n
    assert K.bsr_megakernel.row_tiled_launches == 6    # 65, 4096 twice
    misaligned = torch.zeros(4096 * 512 + 1)[1:].view(4096, 512)
    launch(4096, False, misaligned)
    assert lib.walks[-1] == "split-K" and len(lib.packed) == 2
    K.reset_launches()


def test_megakernel_launch_follows_regrown_state(monkeypatch):
    """Each call passes the kernel the flat schedule's arrival counters
    and occupancy slots as they are at that call, after a larger B grew
    the counters or a new chunk count made the slots anew; the scratch
    grows to the largest call and serves every smaller one."""
    flat = row_net("mlp")
    lib = FakeLib()
    monkeypatch.setattr(K._build, "load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda index: 0)
    occ0 = torch.ones(8, dtype=torch.int32)
    seen = []
    for B in PREPARED_BATCHES:
        x = torch.zeros((B, 512))
        occ = torch.empty((3, 8), dtype=torch.int32)
        K._launch_megakernel(x, flat, 2, 0, occ0, occ, torch.empty((B, 512)))
        call = lib.calls[-1]
        assert call["slots"] == flat.slots.data_ptr()
        assert flat.slots.numel() == occ.numel() * -(-B // 32)
        rows = K.row_tiled(B, flat)
        assert call["arrivals"] == (None if rows else
                                    flat.arrivals.data_ptr())
        assert flat.arrivals.numel() >= (flat.run_ptr.numel() - 1) * \
            -(-B // 32) or rows
        assert call["scratch"] == flat.scratch.data_ptr()
        assert flat.scratch.numel() >= K.megakernel_scratch_floats(B, flat,
                                                                   rows)
        seen.append((call["arrivals"], call["slots"], call["scratch"]))
    # B = 33 grew the counters and remade the slots, and 4,096 the scratch
    assert seen[2][0] != seen[1][0] and seen[2][1] != seen[1][1]
    assert seen[4][2] != seen[3][2]
    assert seen[5][2] == seen[6][2] == seen[4][2]      # kept, not shrunk
    assert lib.packed == ["split-K", "row-tiled"]
    K.reset_launches()


def test_megakernel_rejects_bad_inputs_on_a_packed_schedule(monkeypatch):
    """After a launch has packed the schedule, a call still raises for an
    x of the wrong rank, width or device: the schedule is checked anew on
    a device it was not packed for."""
    flat = row_net("mlp")
    monkeypatch.setattr(K._build, "load", lambda: FakeLib())
    monkeypatch.setattr(K, "_stream", lambda index: 0)
    K._launch_megakernel(torch.zeros((4096, 512)), flat, 2, 0, None, None,
                         torch.empty((4096, 512)))
    with pytest.raises(ValueError):
        K.bsr_megakernel(torch.zeros(512), flat, "relu")
    with pytest.raises(ValueError, match="multiple of the block size"):
        K.bsr_megakernel(torch.zeros((4, 500)), flat, "relu")
    with pytest.raises(ValueError, match="gate=True needs occ0"):
        K.bsr_megakernel(torch.zeros((4, 512)), flat, "relu", gate=True,
                         occ0=torch.ones(7, dtype=torch.int32))
    meta = torch.zeros((4096, 512), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        K.bsr_megakernel(meta, flat, "relu")
    with pytest.raises(ValueError, match="blocks is on cpu, x on meta"):
        K._launch_megakernel(meta, flat, 2, 0, None, None,
                             torch.empty((4096, 512), device="meta"))
    K.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,xdt", (("f32", "f32"), ("bf16", "f32"),
                                     ("fp8", "f32"), ("f32", "bf16")))
@pytest.mark.parametrize("kind", sorted(ROW_NETS))
def test_cuda_row_tiled_megakernel_matches_plain(cuda_device, kind, wdt, xdt):
    """The row-tiled walk on the card at the crossover, one row past it and
    4,096 rows, against the plain version; the batch below the crossover
    takes the split-K walk.  The arrival counters stay zero."""
    flat = row_net(kind, wdt, cuda_device)
    cross = row_crossover(flat)
    n_in = ROW_NETS[kind][0][0]
    gen = torch.Generator().manual_seed(0)
    for B in (cross - 1, cross, cross + 1, 4096):
        x = torch.randn((B, n_in), generator=gen).to(cuda_device)
        x = x.to(torch.bfloat16 if xdt == "bf16" else torch.float32)
        K.reset_launches()
        y = K.bsr_megakernel(x, flat, "gelu", "none")
        y_ref = K.bsr_megakernel_plain(x, flat, "gelu", "none")
        assert y.dtype == x.dtype
        assert err(y.float().cpu(), y_ref.float().cpu()) < \
            {"f32": 1e-4, "bf16": 3e-2}[xdt]
        assert (K.bsr_megakernel.launches,
                K.bsr_megakernel.row_tiled_launches) == (1, int(B >= cross))
        assert not flat.arrivals.any()
    K.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(ROW_NETS))
def test_cuda_row_tiled_gated_bit_equal(cuda_device, kind):
    """The gated row-tiled walk at 4,096 rows, half of x's input tiles and
    half of the hidden tiles dead: output bit-equal to the ungated walk's,
    occupancy equal to the plain version's, one launch of each on the
    row-tiled walk."""
    from repro_torch.engine import tile_occupancy

    flat = row_net(kind, "f32", cuda_device, dead_hidden=True)
    assert flat.row_runs.patch_runs > 0
    (n_in, *_), block = ROW_NETS[kind]
    x = torch.randn((4096, n_in), generator=torch.Generator().manual_seed(1))
    x.reshape(4096, -1, block)[:, ::2] = 0.0
    x = x.to(cuda_device)
    occ0 = tile_occupancy(x, block, n_in // block)
    K.reset_launches()
    y, occ = K.bsr_megakernel(x, flat, "relu", "none", gate=True, occ0=occ0)
    y_ref, occ_ref = K.bsr_megakernel_plain(x, flat, "relu", "none",
                                            gate=True, occ0=occ0)
    assert torch.equal(occ.cpu(), occ_ref.cpu())
    assert (occ == 0).any() and (occ > 0).any()
    assert torch.equal(y, K.bsr_megakernel(x, flat, "relu", "none"))
    assert err(y.cpu(), y_ref.cpu()) < 1e-4
    assert (K.bsr_megakernel.gated_launches, K.bsr_megakernel.launches,
            K.bsr_megakernel.row_tiled_launches) == (1, 1, 2)
    assert not flat.arrivals.any()
    K.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(ROW_NETS))
def test_cuda_row_tiled_patched_tiles_are_act_bias(cuda_device, kind):
    """At 4,096 rows every output tile that ``compile_schedule`` patched
    holds relu(bias) exactly in every row, in each layer of the net: the
    net cut after layer k writes layer k's as its output and leaves layer
    k - 1's in its hidden scratch."""
    layers = row_layers(kind)
    block = ROW_NETS[kind][1]
    B = 4096
    x = torch.randn((B, layers[0].n_in),
                    generator=torch.Generator().manual_seed(5))
    x = x.to(cuda_device)

    def patched(layer, y):
        for t in sorted(set(range(layer.grid_out)) - set(layer.cols.tolist())):
            want = torch.relu(torch.from_numpy(
                layer.bias[t * block:(t + 1) * block])).expand(B, block)
            assert torch.equal(y(t).cpu(), want)

    K.reset_launches()
    for k in range(len(layers)):
        flat = row_flat(layers[:k + 1], "f32", cuda_device)
        out = K.bsr_megakernel(x, flat, "relu", "relu")
        patched(layers[k], lambda t: out[:, t * block:(t + 1) * block])
        if k:
            hidden = flat.scratch[:2 * flat.hidden_tiles * B * block].view(
                2, flat.hidden_tiles, B, block)[(k - 1) % 2]
            patched(layers[k - 1], lambda t: hidden[t])
    assert K.bsr_megakernel.row_tiled_launches == len(layers)
    K.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("B", (65, 4096))
def test_cuda_row_tiled_patch_item_first_after_the_barrier(cuda_device, B):
    """Some CTA starts the second layer of ``late_patch_layers`` on a patch
    item, whose stage it must not issue across the barrier: the output
    within 1e-4 of the plain version and the gated walk's bit-equal to
    it."""
    flat = row_flat(late_patch_layers(), "f32", cuda_device)
    runs = flat.row_runs
    live_items = np.count_nonzero(runs.live[runs.first[1]:runs.first[2]]) \
        * -(-B // K._ROW_BM)
    x = torch.randn((B, 512), generator=torch.Generator().manual_seed(4))
    x = x.to(cuda_device)
    K.reset_launches()
    y = K.bsr_megakernel(x, flat, "relu", "none")
    assert K.bsr_megakernel.row_tiled_launches == 1
    assert K.bsr_megakernel.grid > live_items    # CTA live_items: a patch item
    y_ref = K.bsr_megakernel_plain(x, flat, "relu", "none")
    assert err(y.cpu(), y_ref.cpu()) < 1e-4
    occ0 = torch.full((8,), B, dtype=torch.int32, device=cuda_device)
    yg, _ = K.bsr_megakernel(x, flat, "relu", "none", gate=True, occ0=occ0)
    assert torch.equal(yg, y)
    assert K.bsr_megakernel.row_tiled_launches == 2
    K.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(ROW_NETS))
def test_cuda_prepared_launch_through_both_walks(cuda_device, kind):
    """One flat schedule through B = 1, 32, 33, 65, 4,096, 33, 4,096,
    ungated and gated at each: every output within 1e-4 of the plain
    version, the gated one bit-equal to the ungated one, a repeated call
    bit-equal to the first, and the arrival counters zero after every
    call; one launch block packed per walk and gate."""
    from repro_torch.engine import tile_occupancy

    flat = row_net(kind, "f32", cuda_device, dead_hidden=True)
    (n_in, *_), block = ROW_NETS[kind]
    gen = torch.Generator().manual_seed(2)
    for B in PREPARED_BATCHES:
        x = torch.randn((B, n_in), generator=gen)
        x.reshape(B, -1, block)[:, ::2] = 0.0
        x = x.to(cuda_device)
        occ0 = tile_occupancy(x, block, n_in // block)
        y = K.bsr_megakernel(x, flat, "relu", "none")
        assert not flat.arrivals.any()
        y_ref = K.bsr_megakernel_plain(x, flat, "relu", "none")
        assert err(y.cpu(), y_ref.cpu()) < 1e-4
        assert torch.equal(y, K.bsr_megakernel(x, flat, "relu", "none"))
        yg, occ = K.bsr_megakernel(x, flat, "relu", "none", gate=True,
                                   occ0=occ0)
        assert not flat.arrivals.any()
        assert torch.equal(yg, y)
        _, occ_ref = K.bsr_megakernel_plain(x, flat, "relu", "none",
                                            gate=True, occ0=occ0)
        assert torch.equal(occ.cpu(), occ_ref.cpu())
        yg2, occ2 = K.bsr_megakernel(x, flat, "relu", "none", gate=True,
                                     occ0=occ0)
        assert torch.equal(yg2, y) and torch.equal(occ2, occ)
    assert len(flat.launch_blocks) == 2                # one per walk
    K.reset_launches()


@pytest.mark.cuda
def test_cuda_megakernel_rejects_bad_inputs_on_a_packed_schedule(
        cuda_device):
    """Once the schedule is packed, a call still raises for x of a wrong
    dtype or layout and for a wrong occ0, and a view of x that is not
    16-byte aligned takes the split-K walk, within 1e-4 of the row-tiled
    walk's output."""
    flat = row_net("mlp", "f32", cuda_device)
    x = torch.randn((4096, 512), generator=torch.Generator().manual_seed(3))
    x = x.to(cuda_device)
    y = K.bsr_megakernel(x, flat, "relu", "none")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.bsr_megakernel(x.half(), flat, "relu", "none")
    with pytest.raises(ValueError, match="x must be contiguous"):
        K.bsr_megakernel(x.reshape(512, 4096).t(), flat, "relu", "none")
    occ0 = torch.ones(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="occ0 must be int32"):
        K.bsr_megakernel(x, flat, "relu", "none", gate=True,
                         occ0=occ0.long())
    with pytest.raises(ValueError, match="occ0 is on cpu"):
        K.bsr_megakernel(x, flat, "relu", "none", gate=True,
                         occ0=occ0.cpu())
    base = torch.empty(4096 * 512 + 1, device=cuda_device)
    shifted = base[1:].view(4096, 512)
    shifted.copy_(x)
    K.reset_launches()
    y_split = K.bsr_megakernel(shifted, flat, "relu", "none")
    assert err(y_split.cpu(), y.cpu()) < 1e-4
    assert (K.bsr_megakernel.launches,
            K.bsr_megakernel.row_tiled_launches) == (1, 0)
    assert not flat.arrivals.any()
    K.reset_launches()
