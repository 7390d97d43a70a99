"""The train step that ``CapturedTrainStep`` captures in a CUDA graph, on the
CPU, in f32.

A CUDA graph replays one recorded step against fixed addresses, so the step
must read and write the same state tensors every time: ``make_train_step``
updates every tensor of the optimizer state in place (the step counter
too) and writes the new parameters into the model.  The function the graph
captures (``CapturedTrainStep.body`` on its static batch buffers) runs
here for three steps from the same weights and batches as the eager step,
bit-equal to it, and its metrics within ``METRIC_TOL`` of the reference's
jitted step.  The call's replay path runs with a stand-in graph (a CPU
graph cannot be captured); the graph itself against the eager step runs on
the card (marked ``cuda``).
"""

import contextlib
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config, reduced
from repro_torch.engine import Mesh
from repro_torch.kernels import adamw as A
from repro_torch.launch import train
from repro_torch.launch.steps import (CapturedTrainStep, _state_ptrs,
                                      make_train_step)
from repro_torch.optim import OptConfig
from repro_torch.optim import adamw as tadamw
from test_torch_train import (FAMILIES, METRIC_TOL, OPT, batch, close,
                              jbatch, models, tbatch)

N_STEPS = 3


def state_tensors(params, opt):
    return list(params.parameters()) + [
        opt[k][n] for k in ("master", "mu", "nu") for n in sorted(opt[k])] \
        + [opt["step"]]


def same_state(a_params, a_opt, b_params, b_opt):
    return all(torch.equal(x, y) for x, y in zip(
        state_tensors(a_params, a_opt), state_tensors(b_params, b_opt)))


# =============================================================================
# the eager step writes its state in place
# =============================================================================

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_writes_state_in_place(arch):
    """After a step every tensor of the state is the one passed in (the
    same ``data_ptr``), ``step`` one higher, and so is every parameter."""
    _, tc, _, tp = models(arch)
    opt = tadamw.adamw_init(tp)
    step = make_train_step(tc, OptConfig(**OPT), Mesh(1, 1))
    before = [t.data_ptr() for t in state_tensors(tp, opt)]
    for i in range(2):
        p, o, m = step(tp, opt, tbatch(batch(tc, seed=i, b=4)))
        assert p is tp
        assert [t.data_ptr() for t in state_tensors(p, o)] == before
        assert o["step"] is opt["step"] and int(o["step"]) == i + 1
        assert set(m) == {"loss", "grad_norm", "lr"}


def test_adamw_update_increments_the_given_step():
    """``adamw_update`` returns the step tensor it was given, one higher;
    the schedule read the step before it moved."""
    p = {"w": torch.ones(3)}
    state = tadamw.adamw_init(p)
    step = state["step"]
    cfg = OptConfig(**OPT)
    _, new, met = tadamw.adamw_update({"w": torch.ones(3)}, state, p, cfg)
    assert new["step"] is step and int(step) == 1
    close(float(met["lr"]), float(tadamw.schedule(torch.tensor(0), cfg)),
          1e-7)


def test_meta_step_increments_in_place():
    """The dry run's meta state takes the in-place increment."""
    p = {"w": torch.empty(4, 4, device="meta")}
    state = tadamw.adamw_init(p)
    _, new, _ = tadamw.adamw_update({"w": torch.empty(4, 4, device="meta")},
                                    state, p, OptConfig(**OPT))
    assert new["step"] is state["step"] and new["step"].device.type == "meta"


# =============================================================================
# the captured body on its static buffers
# =============================================================================

def three_ways(arch, n_steps=N_STEPS, **changes):
    """``n_steps`` from the same weights and batches: the eager step, the
    body a graph captures on its static buffers, and the reference's
    jitted step.  (eager state, body state, per-step metrics of each)."""
    jc, tc, jp, tp = models(arch, **changes)
    tq = copy.deepcopy(tp)
    opt_cfg = OptConfig(**OPT)
    eager = make_train_step(tc, opt_cfg, Mesh(1, 1))
    cap = CapturedTrainStep(tc, opt_cfg, Mesh(1, 1))
    jstep = jax.jit(jmake_train_step(jc, JOptConfig(**OPT),
                                     make_test_mesh(1, 1)))
    e_opt, c_opt = tadamw.adamw_init(tp), tadamw.adamw_init(tq)
    jopt = jadamw.adamw_init(jp)
    g = None
    out = {"eager": [], "body": [], "ref": []}
    for i in range(n_steps):
        b = batch(jc, seed=i, b=4)
        _, e_opt, em = eager(tp, e_opt, tbatch(b))
        if g is None:
            g = cap.buffers(tbatch(b))
        else:
            g.load(tbatch(b))
        ptrs = [t.data_ptr() for t in g.batch.values()]
        _, c_opt, cm = cap.body(tq, c_opt, g)
        assert [t.data_ptr() for t in g.batch.values()] == ptrs
        jp, jopt, jm = jstep(jp, jopt, jbatch(b))
        out["eager"].append({k: float(v) for k, v in em.items()})
        out["body"].append({k: float(v) for k, v in cm.items()})
        out["ref"].append({k: float(v) for k, v in jm.items()})
    return (tp, e_opt), (tq, c_opt), out


@pytest.mark.parametrize("arch", FAMILIES)
def test_captured_body_equals_eager_and_tracks_reference(arch):
    """Three steps of the captured body bit-equal to the eager step (every
    metric, parameter and state tensor), the metrics of each step within
    ``METRIC_TOL`` of the reference's."""
    (tp, e_opt), (tq, c_opt), out = three_ways(arch)
    assert out["body"] == out["eager"]
    assert same_state(tp, e_opt, tq, c_opt)
    assert int(c_opt["step"]) == N_STEPS
    for port, ref in zip(out["body"], out["ref"]):
        for k in ref:
            close(port[k], ref[k], METRIC_TOL)


def test_captured_body_with_microbatches():
    """``microbatch=2``: the graph's body unrolls the two microbatches and
    sums their gradients as the eager step does."""
    (tp, e_opt), (tq, c_opt), out = three_ways("codeqwen1.5-7b",
                                               n_steps=2, microbatch=2)
    assert out["body"] == out["eager"]
    assert same_state(tp, e_opt, tq, c_opt)
    for port, ref in zip(out["body"], out["ref"]):
        close(port["loss"], ref["loss"], METRIC_TOL)


# =============================================================================
# the call: replay, identity of the state, failure
# =============================================================================

class StandInGraph:
    """A CPU stand-in for a captured graph: ``replay`` runs the body on the
    static buffers and writes the metrics into the captured outputs."""

    def __init__(self, cap, params, opt, g):
        self.cap, self.params, self.opt, self.g = cap, params, opt, g

    def replay(self):
        _, _, m = self.cap.body(self.params, self.opt, self.g)
        for k, v in m.items():
            self.g.metrics[k].copy_(v)


def stand_in(cap, params, opt, b):
    """``cap`` as after its first call on ``b``'s signature, its graph a
    ``StandInGraph``."""
    g = cap.buffers(b)
    g.metrics = {k: torch.zeros(()) for k in ("loss", "grad_norm", "lr")}
    g.graph = StandInGraph(cap, params, opt, g)
    g.state_ptrs = _state_ptrs(params, opt)
    g.adamw = A.CapturedLaunches(1, "cpu")
    g.adamw.take(np.zeros((1, 8), np.int64))
    cap.graphs[tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(b.items()))] = g
    return g


def test_call_replays_and_returns_the_given_state():
    """A call copies the batch in, replays once, counts the graph's fused
    launches, and returns the objects it was given with metrics cloned out
    of the graph; the result equals the eager step's."""
    _, tc, _, tp = models("granite-moe-1b-a400m")
    tq = copy.deepcopy(tp)
    opt_cfg = OptConfig(**OPT)
    cap = CapturedTrainStep(tc, opt_cfg, Mesh(1, 1))
    eager = make_train_step(tc, opt_cfg, Mesh(1, 1))
    opt, e_opt = tadamw.adamw_init(tp), tadamw.adamw_init(tq)
    g = stand_in(cap, tp, opt, tbatch(batch(tc, seed=0, b=4)))
    CapturedTrainStep.reset_counts()
    launches = A.adamw_fused.launches
    for i in range(2):
        b = tbatch(batch(tc, seed=i, b=4))
        p, o, m = cap(tp, opt, b)
        _, e_opt, em = eager(tq, e_opt, b)
        assert p is tp and o is opt
        assert all(m[k] is not g.metrics[k] for k in m)
        assert {k: float(v) for k, v in m.items()} == \
            {k: float(v) for k, v in em.items()}
    assert CapturedTrainStep.replays == 2
    assert A.adamw_fused.launches - launches == 2 * len(g.adamw.tables) == 2
    assert same_state(tp, opt, tq, e_opt)


def test_call_raises_on_other_state_tensors():
    """A state that is not the captured tensors (here a copy) raises; one
    restored into them in place replays."""
    _, tc, _, tp = models("codeqwen1.5-7b")
    cap = CapturedTrainStep(tc, OptConfig(**OPT), Mesh(1, 1))
    opt = tadamw.adamw_init(tp)
    b = tbatch(batch(tc, seed=0, b=4))
    stand_in(cap, tp, opt, b)
    other = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in opt.items()}
    with pytest.raises(RuntimeError, match="not the tensors"):
        cap(tp, other, b)
    with torch.no_grad():
        for k in ("master", "mu", "nu"):
            for n in opt[k]:
                opt[k][n].copy_(other[k][n])
    assert cap(tp, dict(opt), b)[1] is not None


def test_failed_capture_raises_on_every_later_call():
    _, tc, _, tp = models("mamba2-1.3b")
    cap = CapturedTrainStep(tc, OptConfig(**OPT))
    cap.failed = RuntimeError("capture refused")
    b = tbatch(batch(tc, seed=0, b=4))
    with pytest.raises(RuntimeError, match="capture failed") as e:
        cap(tp, tadamw.adamw_init(tp), b)
    assert e.value.__cause__ is cap.failed


def test_captured_step_is_one_device_only():
    cfg = reduced(get_config("codeqwen1.5-7b"))
    with pytest.raises(ValueError, match="one device"):
        CapturedTrainStep(cfg, OptConfig(**OPT), Mesh(2, 2))


def test_build_on_the_cpu_returns_the_eager_step():
    """``train.build`` on the CPU hands back ``make_train_step``'s eager
    step, which captures nothing."""
    cfg = dataclasses.replace(reduced(get_config("granite-moe-1b-a400m")),
                              microbatch=1)
    CapturedTrainStep.reset_counts()
    params, opt, step = train.build(cfg, Mesh(1, 1), OptConfig(**OPT),
                                    dtype=torch.float32, device="cpu")
    assert not isinstance(step, CapturedTrainStep)
    step(params, opt, tbatch(batch(cfg, b=2)))
    assert int(opt["step"]) == 1
    assert CapturedTrainStep.captures == CapturedTrainStep.replays == 0


def test_captured_launches_upload_and_count():
    """The tables a capture leaves take consecutive rows of the buffer
    allocated before it, are filled once by ``upload``, and may not
    outgrow it; each replay counts one launch per table; ``capturing``
    nests."""
    held, inner = A.CapturedLaunches(3, "cpu"), A.CapturedLaunches(1, "cpu")
    for i, n in enumerate((1, 2)):
        assert held.take(np.full((n, 8), i, np.int64)).shape == (n, 8)
    with pytest.raises(RuntimeError, match="table rows"):
        held.take(np.zeros((1, 8), np.int64))
    held.upload()
    assert held.buffer[:, 0].tolist() == [0, 1, 1]
    before = A.adamw_fused.launches
    held.replayed()
    assert A.adamw_fused.launches == before + 2
    with A.capturing(held):
        with A.capturing(inner):
            assert A._local.captured is inner
        assert A._local.captured is held
    assert getattr(A._local, "captured", None) is None


# =============================================================================
# on the card
# =============================================================================

@contextlib.contextmanager
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python3 "
                    "chip_smoke.py, phase 10)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_graph_equals_eager_on_the_card(arch, cuda_device):
    """Three steps of ``train.build``'s captured step (one warm-up step,
    then two replays) against the eager step from the same weights and
    batches, under deterministic algorithms: bit-equal (granite's MoE
    combine still sums with atomics: its loss within 1e-5)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), microbatch=1)
    opt_cfg = OptConfig(**OPT)
    with deterministic():
        p, o, cap = train.build(cfg, Mesh(1, 1), opt_cfg,
                                dtype=torch.float32, device=cuda_device)
        q, e_opt, _ = train.build(cfg, Mesh(1, 1), opt_cfg,
                                  dtype=torch.float32, device=cuda_device)
        eager = make_train_step(cfg, opt_cfg, Mesh(1, 1))
        assert isinstance(cap, CapturedTrainStep)
        CapturedTrainStep.reset_counts()
        for i in range(N_STEPS):
            b = {k: v.to(cuda_device)
                 for k, v in tbatch(batch(cfg, seed=i, b=4)).items()}
            _, _, m = cap(p, o, b)
            _, e_opt, em = eager(q, e_opt, b)
            close(float(m["loss"]), float(em["loss"]),
                  1e-5 if cfg.family == "moe" else 0.0)
        torch.cuda.synchronize()
    assert CapturedTrainStep.captures == 1
    assert CapturedTrainStep.replays == N_STEPS - 1
    if cfg.family != "moe":
        assert same_state(p, o, q, e_opt)
