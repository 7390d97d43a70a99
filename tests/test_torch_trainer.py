"""The port's data pipeline, tree checkpoints, fault tolerance and training
entry point, on the CPU.

Ports ``tests/test_runtime.py``'s checkpoint and fault-tolerance tests and
``tests/test_system.py``'s training with failure recovery, and checks what
the two packages share: the same token streams, and checkpoints that
either package writes and the other restores (the same paths, leaf count
and leaves, and the next step agrees).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.checkpoint.store import _tree_paths as jtree_paths
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import TokenBatcher as JTokenBatcher
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.optim import OptConfig as JOptConfig
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.store import _tree_paths
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (
    lm_params_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.data import SyntheticLM, TokenBatcher, sharded_batches
from repro_torch.engine import Mesh
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.optim import OptConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import FaultInjector, ResilientTrainer, StragglerMonitor
from test_torch_train import OPT, batch, cfgs, jbatch, tbatch
from test_torch_train_step import check_step


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(256, 0), (1000, 1), (49155, 7)])
def test_token_streams_equal_reference(vocab, seed):
    ref, port = JSyntheticLM(vocab, seed), SyntheticLM(vocab, seed)
    np.testing.assert_array_equal(port.next_tokens, ref.next_tokens)
    np.testing.assert_array_equal(port.cum, ref.cum)
    jb, tb = JTokenBatcher(ref, 4, 16, seed=seed), TokenBatcher(port, 4, 16,
                                                                 seed=seed)
    for step in (0, 1, 5, 1000):
        a, b = jb(step), tb(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


def test_sharded_batches_moves_each_batch():
    tb = TokenBatcher(SyntheticLM(64, 0), 2, 8, seed=1)
    out = list(sharded_batches(tb, "cpu", steps=3))
    assert len(out) == 3
    for step, b in enumerate(out):
        for k, v in tb(step).items():
            assert b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), v)


# ---------------------------------------------------------------------------
# checkpointing (tests/test_runtime.py, on torch trees)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
        "b16": torch.from_numpy(rng.standard_normal((4, 4))).to(torch.bfloat16),
        "nested": {"s": torch.tensor(3, dtype=torch.int32)},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    out = load_checkpoint(str(tmp_path), _zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype
        assert a.reshape(-1).view(torch.uint8).numpy().tobytes() == \
            b.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_checkpoint_atomicity_tmp_never_visible(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_crc_detects_corruption(tmp_path):
    path = save_checkpoint(str(tmp_path), 2, _tree())
    victim = os.path.join(path, "leaf_00000.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        load_checkpoint(str(tmp_path), _tree(), step=2)


def test_manager_retention_and_async(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        m.async_save(s, t)
    m.wait()
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """The copy to the host happens on the caller's thread: an in-place
    update right after ``async_save`` does not reach the file."""
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    before = t["w"].clone()
    m.async_save(1, t)
    t["w"].add_(1.0)
    m.wait()
    out = load_checkpoint(str(tmp_path), _zeros_like(t), step=1)
    assert torch.equal(out["w"], before)


def test_restore_mismatched_tree_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"only": torch.zeros((2,))}, step=1)
    bad_shape = _zeros_like(_tree())
    bad_shape["w"] = torch.zeros((8, 15))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), bad_shape, step=1)
    bad_dtype = _zeros_like(_tree())
    bad_dtype["b16"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(str(tmp_path), bad_dtype, step=1)
    not_tensor = _zeros_like(_tree())
    not_tensor["w"] = np.zeros((8, 16), np.float32)
    with pytest.raises(TypeError, match="tensors only"):
        load_checkpoint(str(tmp_path), not_tensor, step=1)


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def _toy_step():
    """y = w*x regression; a functional train_step."""

    def step(params, opt_state, batch):
        w = params["w"].detach().requires_grad_(True)
        loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        g, = torch.autograd.grad(loss, w)
        return {"w": (w - 0.05 * g).detach()}, opt_state, {"loss": loss.detach()}

    return step


def _toy_batches(step):
    rng = np.random.default_rng(step)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    w_true = np.arange(4, dtype=np.float32)[:, None]
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}


def test_resilient_trainer_recovers_from_injected_faults(tmp_path):
    trainer = ResilientTrainer(
        _toy_step(), {"w": torch.zeros((4, 1))}, {},
        CheckpointManager(str(tmp_path)), ckpt_every=5,
        fault_injector=FaultInjector([7, 13]))
    out = trainer.run(_toy_batches, 25)
    assert out["restarts"] == 2
    assert out["final_loss"] < out["losses"][0]
    assert trainer.step == 25
    assert len([h for h in out["history"] if h[0] == "failure"]) == 2


def test_resilient_trainer_determinism_vs_no_faults(tmp_path):
    """Replayed batches after restart give the same final weights, bit for
    bit on the CPU."""
    t_fault = ResilientTrainer(
        _toy_step(), {"w": torch.zeros((4, 1))}, {},
        CheckpointManager(str(tmp_path / "a")), ckpt_every=5,
        fault_injector=FaultInjector([8]))
    out_f = t_fault.run(_toy_batches, 20)
    t_clean = ResilientTrainer(
        _toy_step(), {"w": torch.zeros((4, 1))}, {},
        CheckpointManager(str(tmp_path / "b")), ckpt_every=5)
    out_c = t_clean.run(_toy_batches, 20)
    assert torch.equal(t_fault.params["w"], t_clean.params["w"])
    assert out_f["restarts"] == 1 and out_c["restarts"] == 0


def test_nan_loss_triggers_restart(tmp_path):
    calls = {"n": 0}

    def step(params, opt_state, batch):
        calls["n"] += 1
        loss = float("nan") if calls["n"] == 3 else 1.0
        return params, opt_state, {"loss": torch.tensor(loss)}

    trainer = ResilientTrainer(step, {"w": torch.zeros(2)}, {},
                               CheckpointManager(str(tmp_path)), ckpt_every=2)
    out = trainer.run(lambda s: {}, 5)
    assert out["restarts"] == 1
    assert trainer.step == 5


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(factor=3.0, warmup=2)
    for i, dt in enumerate([1.0, 1.0, 1.0, 1.0, 10.0, 1.0]):
        mon.observe(i, dt)
    assert len(mon.events) == 1
    assert mon.events[0].step == 4
    assert mon.events[0].factor > 3
    assert mon.ema < 2.0


def test_training_system_with_failure_recovery(tmp_path):
    """tests/test_system.py's: the model's train step + checkpointing +
    fault injection; the loss falls across a simulated node failure."""
    cfg = reduced(get_config("codeqwen1.5-7b"))
    params, opt, step = train.build(
        cfg, Mesh(1, 1), OptConfig(lr=1e-3, warmup_steps=2),
        dtype=torch.float32, device="cpu")

    def batches(s):
        toks = np.random.default_rng(s).integers(0, cfg.vocab, (4, 33))
        return {"tokens": torch.from_numpy(toks[:, :-1]),
                "labels": torch.from_numpy(toks[:, 1:])}

    trainer = ResilientTrainer(
        step, params, opt, CheckpointManager(str(tmp_path)), ckpt_every=4,
        fault_injector=FaultInjector([6]))
    out = trainer.run(batches, 12)
    assert out["restarts"] == 1
    assert out["losses"][-1] < out["losses"][0]


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

ARCH = "zamba2-1.2b"      # stacked layers, shared_attn, f32 SSM leaves


def _states(dtype):
    """The reference's params (its init) and a random optimizer state at
    step 7 (nu large enough that no update is near Adam's eps), as JAX
    trees; the port's own random params and fresh state to load into."""
    jc, tc = cfgs(ARCH)
    jp = jlm.init(jax.random.PRNGKey(0), jc, dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(9)
    leaves, treedef = jax.tree.flatten(jp)
    draw = [treedef.unflatten([
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * s)
        for x in leaves]) for s in (1.0, 0.01, 1e-4)]
    jopt = {"master": draw[0], "mu": draw[1],
            "nu": jax.tree.map(jnp.abs, draw[2]),
            "step": jnp.asarray(7, jnp.int32)}
    tp = tlm.init(torch.Generator().manual_seed(5), tc,
                  dtype=getattr(torch, dtype)).requires_grad_(True)
    return jc, tc, jp, jopt, tp, tadamw.adamw_init(tp)


def _manifest_paths(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["extra"]["paths"]


def _as_f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _next_steps(jc, tc, jp, jopt, tp, topt):
    """One more step in each package from the states each one holds."""
    jstep = jax.jit(jmake_train_step(jc, JOptConfig(**OPT), make_test_mesh(1, 1)))
    tstep = make_train_step(tc, OptConfig(**OPT), Mesh(1, 1))
    b = batch(jc, seed=11, b=4)
    jp, jopt, jm = jstep(jp, jopt, jbatch(b))
    tp, topt, tm = tstep(tp, topt, tbatch(b))
    return ({k: float(v) for k, v in tm.items()}, lm_params_to_numpy(tp),
            opt_state_to_numpy(topt), {k: float(v) for k, v in jm.items()},
            jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jopt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    jc, tc, jp, jopt, tp, topt = _states(dtype)
    jsave_checkpoint(str(tmp_path), 3, {"params": jp, "opt": jopt})
    paths = _manifest_paths(tmp_path, 3)
    assert paths == _tree_paths({"params": tp, "opt": topt})
    out = load_checkpoint(str(tmp_path), {"params": tp, "opt": topt}, step=3)
    assert out["params"] is tp and out["opt"]["mu"] is topt["mu"]
    np.testing.assert_equal(lm_params_to_numpy(tp), _as_f32(jp))
    np.testing.assert_equal(opt_state_to_numpy(topt),
                            jax.tree.map(np.asarray, jopt))
    if dtype == "float32":
        out = _next_steps(jc, tc, jp, jopt, tp, topt)
        check_step(out, out[3]["lr"], first=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    jc, tc, jp, jopt, tp, topt = _states(dtype)
    save_checkpoint(str(tmp_path), 4, {"params": tp, "opt": topt})
    like = {"params": jp, "opt": jopt}
    assert _manifest_paths(tmp_path, 4) == jtree_paths(like)
    out = jload_checkpoint(str(tmp_path), like, step=4)
    assert len(jax.tree.leaves(out)) == len(jax.tree.leaves(like))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(like)):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_equal(_as_f32(out["params"]), lm_params_to_numpy(tp))
    np.testing.assert_equal(jax.tree.map(np.asarray, out["opt"]),
                            opt_state_to_numpy(topt))
    if dtype == "float32":   # the port's fresh state: the first step
        out = _next_steps(jc, tc, out["params"], out["opt"], tp, topt)
        check_step(out, out[3]["lr"])


def test_opt_state_from_reference_checkpoint_arrays(tmp_path):
    """``opt_state_from_numpy`` reads the reference's state as the port's
    (names, shapes, step)."""
    _, _, _, jopt, _, topt = _states("float32")
    back = opt_state_from_numpy(jax.tree.map(np.asarray, jopt), device="cpu")
    assert int(back["step"]) == 7
    for key in ("master", "mu", "nu"):
        assert set(back[key]) == set(topt[key])
        for name, val in topt[key].items():
            assert back[key][name].shape == val.shape


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

ARGS = ["--device", "cpu", "--reduced", "--steps", "12", "--ckpt-every", "4"]


def test_train_main_end_to_end(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --reduced``: a
    fault at step 6 restarts once, the loss falls, the final state equals
    a run without the fault bit for bit, and the last checkpoint restores
    into a fresh model and state bit for bit."""
    run = train.main(ARGS + ["--inject-fault-at", "6",
                             "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=granite-moe-1b-a400m-reduced params=0.2M "
                             "mesh={'data': 1, 'model': 1}")
    assert out[1].startswith("steps=12 ") and "restarts=1" in out[1]
    # steps 4 and 5 ran twice: the restart went back to step 4's checkpoint
    losses = run.summary["losses"]
    assert run.summary["restarts"] == 1 and len(losses) == 14
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    clean = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean.summary["restarts"] == 0
    assert clean.summary["losses"][4:] == losses[6:] == losses[4:6] + losses[8:]
    for a, b in ((run.trainer.params, clean.trainer.params),):
        for (name, x), y in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(x, y), name
    np.testing.assert_equal(opt_state_to_numpy(run.trainer.opt_state),
                            opt_state_to_numpy(clean.trainer.opt_state))
    fresh_p, fresh_o, _ = train.build(run.cfg, Mesh(1, 1), OptConfig(),
                                      seed=3, device="cpu")
    CheckpointManager(str(tmp_path / "a")).restore(
        {"params": fresh_p, "opt": fresh_o})
    for (name, x), y in zip(fresh_p.named_parameters(),
                            run.trainer.params.parameters()):
        assert torch.equal(x, y), name
    np.testing.assert_equal(opt_state_to_numpy(fresh_o),
                            opt_state_to_numpy(run.trainer.opt_state))


def test_train_main_needs_a_card_for_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("flag", ["--data-mesh", "--model-mesh"])
def test_train_main_one_device_only(tmp_path, flag):
    """A mesh axis of 2 is no longer one device: ``main`` spawns two gloo
    processes, which train (the 2x2 mesh and its fault are
    ``test_torch_distribution.py``'s)."""
    run = train.main(ARGS + [flag, "2", "--steps", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert run.backend == "gloo" and run.trainer is None
    losses = run.summary["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
