"""Schedule packing parity: the port's arrays equal the reference's exactly.

Integer arrays and scales compare with exact equality; quantized blocks
compare as raw bytes (torch's bf16/fp8 conversions against ml_dtypes').
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.blocksparse import to_bsr
from repro.kernels import ops as jops
from repro_torch.convert import layers_from_numpy
from repro_torch.kernels import ops as tops

WDTS = ("f32", "bf16", "fp8")


def raw(a) -> bytes:
    """Raw bytes of a reference array or a port tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def assert_schedule_equal(js, ts):
    for name in ("rows", "cols", "first", "last"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy())
        assert getattr(ts, name).dtype == torch.int32
    assert (js.grid_out, js.sim_reads, js.sim_writes, js.weight_dtype) == \
        (ts.grid_out, ts.sim_reads, ts.sim_writes, ts.weight_dtype)
    assert raw(js.blocks) == raw(ts.blocks)
    assert (js.scales is None) == (ts.scales is None)
    if js.scales is not None:
        np.testing.assert_array_equal(np.asarray(js.scales), ts.scales.numpy())
    assert (js.weight_bytes, js.scale_bytes) == (ts.weight_bytes, ts.scale_bytes)


@pytest.mark.parametrize("wdt", WDTS)
@pytest.mark.parametrize("density", [0.4, 0.1])
def test_compile_schedule_matches_reference(make_stack, wdt, density):
    """Includes the patch blocks that low density leaves for empty tiles."""
    for jl in make_stack(sizes=(128, 256, 128), density=density, block=32):
        tl = layers_from_numpy([jl])[0]
        perm = np.lexsort((jl.rows, jl.cols))
        assert_schedule_equal(jops.compile_schedule(jl, perm, wdt),
                              tops.compile_schedule(tl, perm, wdt))


def test_run_ptr_marks_every_output_tile_run(make_stack):
    lay = layers_from_numpy(make_stack(density=0.2, block=32))[0]
    sch = tops.compile_schedule(lay, np.lexsort((lay.rows, lay.cols)))
    run_ptr = sch.run_ptr.numpy()
    first = sch.first.numpy()
    assert len(run_ptr) == lay.grid_out + 1
    np.testing.assert_array_equal(run_ptr[:-1], np.flatnonzero(first))
    assert run_ptr[-1] == len(first)


@pytest.mark.parametrize("wdt", WDTS)
def test_compile_flat_schedule_matches_reference(make_stack, wdt):
    jls = make_stack(sizes=(128, 256, 192, 128), density=0.3, block=32)
    tls = layers_from_numpy(jls)
    jschs, tschs = [], []
    for jl, tl in zip(jls, tls):
        perm = np.lexsort((jl.rows, jl.cols))
        jschs.append(jops.compile_schedule(jl, perm, wdt))
        tschs.append(tops.compile_schedule(tl, perm, wdt))
    jf = jops.compile_flat_schedule(jls, jschs)
    tf = tops.compile_flat_schedule(tls, tschs)
    for name in ("rows", "cols", "first", "last", "layer_id", "hbm_row",
                 "out_tile", "bias_idx", "bias_tiles"):
        np.testing.assert_array_equal(np.asarray(getattr(jf, name)),
                                      getattr(tf, name).numpy(), err_msg=name)
    for name in ("segments", "n_layers", "block", "grid_out_final", "n_out",
                 "hidden_tiles", "per_layer_io", "weight_dtype", "nnz",
                 "weight_bytes", "scale_bytes", "sim_reads", "sim_writes"):
        assert getattr(jf, name) == getattr(tf, name), name
    assert raw(jf.blocks) == raw(tf.blocks)
    if jf.scales is not None:
        np.testing.assert_array_equal(np.asarray(jf.scales), tf.scales.numpy())
    # the port's run table: each layer's runs, in flat order
    run_ptr = tf.run_ptr.numpy()
    for k, (s, e) in enumerate(tf.segments):
        starts = run_ptr[(run_ptr >= s) & (run_ptr < e)]
        assert starts[0] == s and e in run_ptr
        assert len(starts) == tls[k].grid_out
    assert tf.max_layer_steps == max(e - s for s, e in tf.segments)


def test_flat_schedule_rejects_non_uniform_tiles():
    rng = np.random.default_rng(0)
    a = to_bsr(rng.standard_normal((64, 128)).astype(np.float32), 32, 64)
    b = to_bsr(rng.standard_normal((128, 64)).astype(np.float32), 64, 32)
    tls = layers_from_numpy([a, b])
    schs = [tops.compile_schedule(l, np.lexsort((l.rows, l.cols)))
            for l in tls]
    with pytest.raises(ValueError, match="uniform square tile"):
        tops.compile_flat_schedule(tls, schs)


def test_schedule_rejects_non_contiguous():
    rng = np.random.default_rng(1)
    lay = layers_from_numpy(
        [to_bsr(rng.standard_normal((256, 256)).astype(np.float32), 64, 64,
                density=0.8)])[0]
    perm = np.lexsort((lay.cols, lay.rows))    # row-major: interleaves tiles
    with pytest.raises(ValueError, match="contiguous"):
        tops.compile_schedule(lay, perm)


@pytest.mark.parametrize("wdt", ("bf16", "fp8"))
def test_quantized_bytes_match_ml_dtypes(wdt):
    """200 random 32x32 blocks, scaled so some land exactly on the fp8
    absmax/448 edge: torch's conversion gives ml_dtypes' bytes."""
    rng = np.random.default_rng(7)
    blocks = (rng.standard_normal((200, 32, 32))
              * rng.uniform(1e-3, 1e3, (200, 1, 1))).astype(np.float32)
    blocks[3] = 0.0
    jq, js = jops.quantize_blocks(blocks, wdt)
    tq, ts = tops.quantize_blocks(blocks, wdt)
    assert np.asarray(jq).dtype == (ml_dtypes.bfloat16 if wdt == "bf16"
                                    else ml_dtypes.float8_e4m3fn)
    assert raw(jq) == raw(tq)
    np.testing.assert_array_equal(js, ts)


def test_weight_dtype_names():
    for name in (None, "f32", "float32", "bf16", "bfloat16", "fp8", "f8",
                 "float8_e4m3fn"):
        assert tops.resolve_weight_dtype(name) == \
            jops.resolve_weight_dtype(name)
    assert [tops.weight_itemsize(w) for w in WDTS] == [4, 2, 1]
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        tops.resolve_weight_dtype("int4")
