"""The dry run's cost analysis (``repro_torch.launch.cost_analysis``) on the
CPU, against the reference's ``repro.launch.hlo_analysis`` and against
real steps.

* ``model_flops_for`` equals the reference's for every (arch x applicable
  shape), exactly; ``roofline`` equals the reference's formula field by
  field, its three time terms scaled by the ratios of the constants.
* Trip counts: a 7-iteration loop of an 8x8 matmul and an all-reduce in a
  fake 2-rank world counts 7 x its FLOPs and bytes (unrolled or
  trip-counted), an all-gather outside it once; ``_flash``'s chunk loops
  and the train step's microbatches counted by trip count equal the fully
  unrolled trace: FLOPs and every collective's calls and bytes exactly,
  the peak of live bytes within 1 %, and equal for a forward (with
  gradients, the trip-counted trace sums the gradient of the repeated
  iteration's output from its n - 1 slices while it still holds the other
  iterations' bytes).
* ``meta`` equals real: a reduced arch per family counts the same FLOPs
  traced on ``meta`` as ``FlopCounterMode`` counts on real CPU tensors, for
  train, prefill and decode.
* The live-byte tracker equals a hand count on a two-layer MLP, forward
  and forward plus backward.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.launch import hlo_analysis as ref
from repro.models.config import LM_SHAPES as JLM_SHAPES
from repro.models.config import applicable_shapes as japplicable_shapes
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import encdec, lm
from repro_torch.models.config import LM_SHAPES
from repro_torch.models.sharding import (axes_from_mesh, gather, reduce_,
                                         set_mesh)
from repro_torch.models.tripcount import trips
from repro_torch.optim import OptConfig, adamw_init

CELLS = [(a, s) for a in ARCH_IDS for s in japplicable_shapes(jget_config(a))]
FAMILY_ARCHS = ["codeqwen1.5-7b", "granite-moe-1b-a400m", "mamba2-1.3b",
                "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b"]
PEAK_TOL = 0.01


def test_thirty_two_cells():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    assert ca.model_flops_for(get_config(arch), LM_SHAPES[shape]) == \
        ref.model_flops_for(jget_config(arch), JLM_SHAPES[shape])


@pytest.mark.parametrize("flops,arg,temp,coll", [
    (4.2e13, 3.6e8, 1.5e10, 2.9e10),     # collective-bound
    (9.0e14, 2.0e9, 1.0e10, 1.0e9),      # compute-bound
    (1.0e9, 3.0e10, 2.0e10, 1.0e6),      # memory-bound
])
def test_roofline_equals_reference_formula(flops, arg, temp, coll):
    by_op = {"all-reduce": int(coll * 0.6), "all-to-all": int(coll * 0.4)}
    mf, chips = 2.7e15, 256
    mem = ca.MemoryStats(int(arg), 16, int(temp))
    port = ca.roofline(ca.ModuleCost(flops, by_op),
                       ca.CollectiveStats(sum(by_op.values()), by_op, 7),
                       chips, mf, mem)
    jmem = types.SimpleNamespace(argument_size_in_bytes=int(arg),
                                 output_size_in_bytes=16,
                                 temp_size_in_bytes=int(temp))
    theirs = ref.roofline(ref.ModuleCost(flops, by_op, 0, []),
                          ref.CollectiveStats(sum(by_op.values()), by_op, 0),
                          chips, mf, jmem)
    p, r = port.as_dict(), theirs.as_dict()
    assert set(p) == set(r)
    scale = {"compute_s": ref.PEAK_FLOPS / ca.PEAK_FLOPS,
             "memory_s": ref.HBM_BW / ca.HBM_BW,
             "collective_s": ref.LINK_BW / ca.LINK_BW}
    for key, val in r.items():
        if key in scale:
            assert p[key] == pytest.approx(val * scale[key], rel=1e-12)
        elif key != "dominant":
            assert p[key] == val, key
    terms = {"compute": p["compute_s"], "memory": p["memory_s"],
             "collective": p["collective_s"]}
    assert p["dominant"] == max(terms, key=terms.get)
    assert (ca.PEAK_FLOPS, ca.HBM_BW, ca.LINK_BW) == (989e12, 3.35e12, 450e9)


# --------------------------------------------------------------------------- #
# trip counts
# --------------------------------------------------------------------------- #

def _fake_mesh(data, model):
    mesh = make_test_mesh(data, model).bind()
    axes_from_mesh(mesh)
    set_mesh(mesh)
    return mesh


@pytest.mark.parametrize("trip_counts", [False, True])
def test_trip_count_aware_collectives_and_flops(trip_counts):
    """The counterpart of the reference's test: a loop of 7 (an 8x8 matmul
    and an all-reduce), an all-gather outside it."""
    with dryrun.fake_world(2):
        mesh = _fake_mesh(1, 2)

        def step(x, w):
            y = x
            for _ in trips(7):
                y = reduce_(y @ w, mesh)
            return gather(y, mesh, "model")

        x = torch.empty(8, 8, device="meta")
        w = torch.empty(8, 8, device="meta")
        cost, _ = ca.analyze_step(step, x, w, trip_counts=trip_counts)
    assert cost.flops == 7 * 2 * 8 * 8 * 8
    assert cost.coll_by_op == {"all-reduce": 7 * 256, "all-gather": 256}
    assert cost.coll_calls == {"all-reduce": 7, "all-gather": 1}
    stats = ca.collective_stats(cost)
    assert (stats.total_bytes, stats.count) == (8 * 256, 8)


def _trip_case(kind):
    """(step, args) of a reduced dense model with 4 x 4 chunk pairs per
    attention (S = 16, chunk 4) in a fake 1x2 world's rank 0."""
    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b")),
                              attn_chunk=4, remat=kind == "remat",
                              microbatch=4 if kind == "microbatch" else 1)
    mesh = _fake_mesh(1, 2)
    shape = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=16,
                                global_batch=8)
    if kind == "forward":
        shape = dataclasses.replace(shape, kind="prefill")
    return dryrun.build_cell(cfg, shape, mesh)


@pytest.mark.parametrize("kind", ["forward", "backward", "remat",
                                  "microbatch"])
def test_trip_counted_loops_equal_unrolled(kind):
    out = {}
    for tc in (False, True):
        with dryrun.fake_world(2):
            step, args = _trip_case(kind)
            out[tc] = ca.analyze_step(step, *args, trip_counts=tc)
    (c0, m0), (c1, m1) = out[False], out[True]
    assert c1.flops == c0.flops > 0
    assert c1.coll_by_op == c0.coll_by_op and c1.coll_calls == c0.coll_calls
    assert c0.coll_calls["all-reduce"] > 0
    assert m1.argument_size_in_bytes == m0.argument_size_in_bytes
    assert m1.output_size_in_bytes == m0.output_size_in_bytes
    assert abs(m1.peak_bytes - m0.peak_bytes) <= PEAK_TOL * m0.peak_bytes
    if kind == "forward":
        assert m1.peak_bytes == m0.peak_bytes


def test_a_tensor_off_meta_is_an_error():
    with pytest.raises(ValueError, match="meta"):
        ca.analyze_step(lambda x: x * 2, torch.zeros(3))


# --------------------------------------------------------------------------- #
# meta equals real
# --------------------------------------------------------------------------- #

B, S, W = 2, 8, 12


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32))


def _real(cfg, kind):
    mod = encdec if cfg.family == "encdec" else lm
    params = mod.init(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32)
    if kind == "train":
        params.requires_grad_(True)
        b = {"labels": _tokens(cfg, B, S, 1)}
        if cfg.family == "encdec":
            b = {"src_embeds": torch.randn(B, S, cfg.d_model),
                 "tgt_tokens": _tokens(cfg, B, S // cfg.tgt_frac),
                 "labels": _tokens(cfg, B, S // cfg.tgt_frac, 1)}
        elif cfg.modality == "vision_stub":
            b["embeds"] = torch.randn(B, S, cfg.d_model)
        else:
            b["tokens"] = _tokens(cfg, B, S)
        return make_train_step(cfg, OptConfig()), (params, adamw_init(params),
                                                    b)
    params.requires_grad_(False)
    if kind == "prefill":
        if cfg.family == "encdec":
            b = {"src_embeds": torch.randn(B, S, cfg.d_model),
                 "tgt_tokens": _tokens(cfg, B, S // cfg.tgt_frac)}
        elif cfg.modality == "vision_stub":
            b = {"embeds": torch.randn(B, S, cfg.d_model)}
        else:
            b = {"tokens": _tokens(cfg, B, S)}
        return make_prefill_step(cfg), (params, b)
    if cfg.family == "encdec":
        caches = encdec.make_dec_caches(params, cfg,
                                        torch.randn(B, W, cfg.d_model), W)
    else:
        caches = lm.make_caches(cfg, B, W, device="cpu")
    return make_serve_step(cfg), (params, caches, _tokens(cfg, B, 1))


def _meta(cfg, kind):
    params = specs.params_shape(cfg, dtype=torch.float32)
    if kind == "train":
        params.requires_grad_(True)
        shape = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=S,
                                    global_batch=B)
        return make_train_step(cfg, OptConfig()), (
            params, adamw_init(params), specs.train_inputs(cfg, shape))
    params.requires_grad_(False)
    if kind == "prefill":
        shape = dataclasses.replace(LM_SHAPES["prefill_32k"], seq_len=S,
                                    global_batch=B)
        return make_prefill_step(cfg), (params,
                                        specs.prefill_inputs(cfg, shape))
    shape = dataclasses.replace(LM_SHAPES["decode_32k"], seq_len=W,
                                global_batch=B)
    caches, tok = specs.decode_inputs(cfg, shape)
    return make_serve_step(cfg), (params, caches, tok["tokens"])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_flops_equal_real(arch, kind):
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_chunk=4,
                              remat=True, microbatch=2)
    torch.manual_seed(0)
    step, args = _real(cfg, kind)
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        with FlopCounterMode(display=False) as counter:
            step(*args)
    step, args = _meta(cfg, kind)
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        cost, _ = ca.analyze_step(step, *args)
    assert cost.flops == counter.get_total_flops() > 0


# --------------------------------------------------------------------------- #
# live bytes, by hand
# --------------------------------------------------------------------------- #

NB, D, F = 4, 8, 32          # rows, width, hidden width; f32


def _mlp():
    x = torch.empty(NB, D, device="meta")
    w1 = torch.empty(D, F, device="meta", requires_grad=True)
    w2 = torch.empty(F, D, device="meta", requires_grad=True)
    return x, w1, w2


def test_live_bytes_of_a_forward_equal_a_hand_count():
    def forward(x, w1, w2):
        with torch.no_grad():
            return torch.relu(x @ w1) @ w2

    cost, mem = ca.analyze_step(forward, *_mlp())
    bf, bd, args = 4 * NB * F, 4 * NB * D, 4 * (NB * D + 2 * D * F)
    assert mem.argument_size_in_bytes == args
    # x @ w1 and its relu are live together; then the product is freed
    # and the output joins the relu
    assert mem.temp_size_in_bytes == max(2 * bf, bf + bd)
    assert mem.output_size_in_bytes == bd
    assert cost.flops == 2 * NB * D * F * 2


def test_live_bytes_of_a_step_equal_a_hand_count():
    def step(x, w1, w2):
        loss = (torch.relu(x @ w1) @ w2).sum()
        return (loss, *torch.autograd.grad(loss, [w1, w2]))

    cost, mem = ca.analyze_step(step, *_mlp())
    bf, fd, scalar = 4 * NB * F, 4 * F * D, 4
    # forward: x @ w1 and its relu (saved for both backward products) live
    # together.  Backward, with the loss and its seed gradient (one scalar
    # each) alive: the relu, the gradient into it and w2's gradient, then
    # the relu's backward output before those two are freed; last w1's
    # gradient beside w2's and the relu's backward output
    peaks = [2 * bf, 2 * scalar + 3 * bf + fd, 2 * scalar + bf + 2 * fd]
    assert mem.temp_size_in_bytes == max(peaks)
    assert mem.output_size_in_bytes == scalar + 2 * fd
    # two products forward; three backward (x needs no gradient)
    assert cost.flops == 5 * 2 * NB * D * F


def test_memory_record_has_the_reference_keys():
    mem = ca.MemoryStats(10, 3, 5)
    assert mem.record() == {"argument_bytes_per_dev": 10,
                            "output_bytes_per_dev": 3,
                            "temp_bytes_per_dev": 5,
                            "peak_est_bytes_per_dev": 15}
    assert not dist.is_initialized()
