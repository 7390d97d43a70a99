"""The port on a mesh of processes against the reference, on the CPU.

Ports ``tests/test_distribution.py`` (a2a against the dense dispatch, a 2x2
train step, an elastic reshard, the ring matmul, ``quantized_psum``) and
``tests/test_runtime.py``'s compression checks.  One module fixture runs
three things at once, each against a deadline:

  * the reference on a 2x2 host mesh, in a subprocess with four host
    devices (``moe_a2a``, ``row_parallel_matmul`` with ``bf16_reduce``,
    granite's train step, and ``quantized_psum`` on a (4,) mesh);
  * the port in four ``gloo`` processes, one per mesh slot, that
    rendezvous through a ``FileStore`` (``WORKER``), fed the reference's
    weights and the same seeded batches;
  * the reference's one-device train steps, in this process.

Tolerances: a step's loss within 1e-5 and ``grad_norm`` within 1e-4, the
new master within ``1e-2 * lr`` plus Adam's bound for near-zero gradients
(``test_torch_train_step.check_step``); ``moe_a2a`` within 1e-4 of the
dense dispatch and its aux loss within 1e-5 of the reference's a2a (the
aux is a per-shard estimator there too); the ring within 1e-5;
``quantized_psum`` within 1e-6 of the reference's.  Reshards and saves
are bit for bit.  The aux loss makes granite's 2x2 loss differ from one
device's, so its step is held against the reference's own 2x2 step.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_config, reduced
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import layers as jlayers
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro_torch.checkpoint import read_manifest_dir
from repro_torch.convert import lm_params_from_numpy, named_to_numpy
from repro_torch.launch import train
from repro_torch.optim import OptConfig
from repro_torch.runtime import compression as tcomp
from test_torch_train import OPT, batch, cfgs, jbatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300.0
STEP_ARCHS = ["codeqwen1.5-7b", "granite-moe-1b-a400m", "mamba2-1.3b",
              "zamba2-1.2b", "seamless-m4t-medium"]
ONE_DEVICE = [a for a in STEP_ARCHS if a != "granite-moe-1b-a400m"]
B, S = 4, 20


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import (AxisType, make_mesh, named_shardings, set_mesh,
                              shard_map)
    from repro.configs import get_config, reduced
    from repro.launch import partition
    from repro.launch.steps import make_train_step
    from repro.models import layers, lm
    from repro.models.sharding import axes_from_mesh
    from repro.optim import OptConfig, adamw_init
    from repro.runtime.compression import quantized_psum
    inp, out, opt = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    d = dict(np.load(inp))
    res = {}
    mesh = make_mesh((2, 2), ('data', 'model'), axis_types=(AxisType.Auto,) * 2)
    axes_from_mesh(mesh); set_mesh(mesh)
    cfg = reduced(get_config('granite-moe-1b-a400m'))
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    p = layers.init_moe(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    x = jnp.asarray(d['moe_x'])
    res['moe_dense_y'], _ = jax.jit(lambda p_, x_: layers.moe_dense(p_, x_, cfg))(p, x)
    _, res['moe_a2a_aux'] = jax.jit(lambda p_, x_: layers.moe_a2a(p_, x_, cfg, mesh))(p, x)
    rcfg = dataclasses.replace(reduced(get_config('codeqwen1.5-7b')), bf16_reduce=True)
    h, w, ct = (jnp.asarray(d[k]) for k in ('rp_h', 'rp_w', 'rp_ct'))
    rp = lambda h_, w_: layers.row_parallel_matmul(h_, w_, rcfg)
    res['rp_y'] = jax.jit(rp)(h, w)
    res['rp_dh'], res['rp_dw'] = jax.jit(jax.grad(
        lambda h_, w_: jnp.sum(rp(h_, w_) * ct), argnums=(0, 1)))(h, w)
    gcfg = reduced(get_config('granite-moe-1b-a400m'))
    params = lm.init(jax.random.PRNGKey(0), gcfg, dtype=jnp.float32)
    p_specs = partition.params_specs(mesh, jax.eval_shape(lambda: params))
    params = jax.device_put(params, partition.to_named(mesh, p_specs))
    st = adamw_init(params)
    o_specs = partition.opt_specs(mesh, jax.eval_shape(lambda: st), p_specs)
    st = jax.device_put(st, partition.to_named(mesh, o_specs))
    step = jax.jit(make_train_step(gcfg, OptConfig(**opt), mesh),
                   in_shardings=named_shardings(mesh, (p_specs, o_specs, None)),
                   out_shardings=named_shardings(mesh, (p_specs, o_specs, None)))
    b = {k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith('b_')}
    _, st, m = step(params, st, b)
    res['loss'], res['grad_norm'], res['lr'] = m['loss'], m['grad_norm'], m['lr']
    for key in ('master', 'mu'):
        for path, leaf in jax.tree_util.tree_flatten_with_path(st[key])[0]:
            res[key + jax.tree_util.keystr(path)] = leaf
    mesh4 = make_mesh((4,), ('data',), axis_types=(AxisType.Auto,))
    set_mesh(mesh4)
    fn = shard_map(lambda g: quantized_psum(g[0], 'data'), mesh=mesh4,
                   in_specs=P('data', None), out_specs=P())
    res['psum'] = jax.jit(fn)(jnp.asarray(d['psum_g']))
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
""")


WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inp, out, opt = sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6]
    torch.set_num_threads(1)
    dist.init_process_group('gloo', store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import partition, specs
    from repro_torch.launch.mesh import DeviceMesh, make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import encdec, lm, layers
    from repro_torch.models.sharding import STATS
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.runtime import (quantized_psum, reshard_checkpoint,
                                     ring_ag_matmul)
    opt_cfg = OptConfig(**json.loads(opt))
    mesh = make_test_mesh(2, 2).bind()
    d, m = mesh.coord('data'), mesh.coord('model')
    res = {}
    ld = lambda name: torch.load(os.path.join(inp, name), weights_only=False)

    def rows(x, n=2, i=None):
        i = d if i is None else i
        return x.chunk(n, 0)[i]

    def state_of(model, o_specs, opt_state, p_specs):
        full = partition.gather_named(dict(model.named_parameters()),
                                      p_specs, mesh)
        tree = {k: partition.gather_named(opt_state[k], o_specs[k], mesh)
                for k in ('master', 'mu', 'nu')}
        return full, tree

    def local_model(cfg, state):
        cls = encdec.EncDec if cfg.family == 'encdec' else lm.LM
        model = cls(cfg, device='cpu', dtype=torch.float32)
        model.load_state_dict(state)
        p_specs = partition.params_specs(mesh, model)
        partition.shard_module(model.requires_grad_(True), p_specs, mesh)
        o_specs = partition.opt_specs(
            mesh, adamw_init(specs.params_shape(cfg, torch.float32)), p_specs)
        return model, p_specs, o_specs

    for arch in %(archs)r:
        cfg = reduced(get_config(arch))
        data = ld(arch + '.pt')
        b = {k: rows(torch.from_numpy(v)) for k, v in data['batch'].items()}
        for zero2 in (True, False):
            model, p_specs, o_specs = local_model(cfg, data['state'])
            st = partition.opt_init(model, o_specs, mesh)
            step = make_train_step(cfg, opt_cfg, mesh, grad_specs=(
                o_specs['master'] if zero2 else None))
            _, st, met = step(model, st, b)
            depth = partition.depths(o_specs['master'])
            holds = True
            for k in ('master', 'mu', 'nu'):
                mine = {n for n, s in o_specs[k].items()
                        if partition.owns(n, s, mesh, depth)}
                holds &= set(st[k]) == mine
                full = dict(specs.params_shape(cfg).named_parameters())
                for n in mine:
                    want = partition.local_shape(full[n].shape,
                                                 partition.leaf_spec(n, o_specs[k][n]), mesh)
                    holds &= tuple(st[k][n].shape) == want
            params, tree = state_of(model, o_specs, st, p_specs)
            res[f'{arch}/{zero2}'] = {
                'loss': float(met['loss']), 'grad_norm': float(met['grad_norm']),
                'lr': float(met['lr']), 'holds': bool(holds),
                'params_are_master': all(torch.equal(params[n], tree['master'][n])
                                         for n in params),
                'master': tree['master'], 'mu': tree['mu']}
            if arch == 'codeqwen1.5-7b' and zero2:
                shard = {'params': partition.to_named(mesh, p_specs),
                         'opt': partition.to_named(mesh, o_specs)}
                CheckpointManager(os.path.join(out, 'sharded'), keep=2,
                                  shardings=shard).save(3, {'params': model, 'opt': st})
                if rank == 0:
                    save_checkpoint(os.path.join(out, 'one'), 3, {
                        'params': params, 'opt': dict(tree, step=st['step'])})
                dist.barrier()
                if rank < 2:
                    # the 2x2 save restored onto a 2x1 mesh: ranks 0 and 1
                    # (the load itself runs no collective)
                    new = DeviceMesh(('data', 'model'), (2, 1), coords=(rank, 0),
                                     groups={})
                    shape = specs.params_shape(cfg, torch.float32)
                    p2, o2 = reshard_checkpoint(
                        CheckpointManager(os.path.join(out, 'sharded')), cfg, new,
                        shape, adamw_init(shape), device='cpu')
                    ps2 = partition.params_specs(new, shape)
                    os2 = partition.opt_specs(new, adamw_init(shape), ps2)
                    ok = all(torch.equal(t, partition.local_shard(
                        params[n], partition.leaf_spec(n, ps2[n]), new))
                        for n, t in p2.named_parameters())
                    for k in ('master', 'mu', 'nu'):
                        ok &= all(torch.equal(t, partition.local_shard(
                            tree[k][n], partition.leaf_spec(n, os2[k][n]), new))
                            for n, t in o2[k].items())
                        depth = partition.depths(os2[k])
                        ok &= set(o2[k]) == {n for n, s in os2[k].items()
                                             if partition.owns(n, s, new, depth)}
                    res['reshard_2x1'] = bool(ok)
                    res['reshard_2x1_shapes'] = {n: tuple(t.shape) for n, t in
                                                 p2.named_parameters()}
                # the reference's file into this 2x2 world
                shape = specs.params_shape(cfg, torch.float32)
                p3, o3 = reshard_checkpoint(
                    CheckpointManager(os.path.join(inp, 'ref_ckpt')), cfg, mesh,
                    shape, adamw_init(shape), device='cpu')
                full = data['state']
                res['reference_file'] = all(torch.equal(t, partition.local_shard(
                    full[n], partition.leaf_spec(n, p_specs[n]), mesh))
                    for n, t in p3.named_parameters()) and all(
                    torch.equal(t, partition.local_shard(
                        full[n], partition.leaf_spec(n, o_specs['master'][n]),
                        mesh)) for n, t in o3['master'].items())

    # moe_a2a on 2x2 (no-drop capacity)
    mo = ld('moe.pt')
    cfg = dataclasses.replace(reduced(get_config('granite-moe-1b-a400m')),
                              capacity_factor=4.0)
    p = layers.MoE(cfg, 'cpu', torch.float32)
    p.load_state_dict(mo['state'])
    partition.shard_module(p, partition.params_specs(mesh, p), mesh)
    y, aux = layers.moe_a2a(p, rows(torch.from_numpy(mo['x'])), cfg, mesh)
    res['moe_y'], res['moe_aux'] = y, float(aux)

    # row_parallel_matmul with bf16_reduce: no collective in the backward
    rp = ld('rp.pt')
    rcfg = dataclasses.replace(reduced(get_config('codeqwen1.5-7b')),
                               bf16_reduce=True)
    h = rows(torch.from_numpy(rp['h'])).chunk(2, -1)[m].clone().requires_grad_(True)
    w = torch.from_numpy(rp['w']).chunk(2, 0)[m].clone().requires_grad_(True)
    y = layers.row_parallel_matmul(h, w, rcfg, mesh)
    before = sum(STATS.calls.values())
    (y * rows(torch.from_numpy(rp['ct']))).sum().backward()
    res['rp'] = {'y': y.detach(), 'dh': h.grad, 'dw': w.grad,
                 'backward_calls': sum(STATS.calls.values()) - before}

    # the ring matmul on 2x2 and 1x4
    ring = ld('ring.pt')
    mesh14 = make_test_mesh(1, 4).bind()
    for name, mm, nd in (('2x2', mesh, 2), ('1x4', mesh14, 1)):
        i = mm.coord('model')
        tp = mm.axis_size('model')
        xl = rows(torch.from_numpy(ring['x']), nd, mm.coord('data'))
        xl = xl.chunk(tp, 1)[i]
        wl = torch.from_numpy(ring['w']).chunk(tp, 1)[i]
        res['ring_' + name] = ring_ag_matmul(xl, wl, mm)

    # quantized_psum over 4 data ranks
    mesh41 = make_test_mesh(4, 1).bind()
    g = torch.from_numpy(ld('ring.pt')['psum_g'])
    res['psum'] = quantized_psum(g[mesh41.coord('data')], mesh41, 'data')
    res['stats'] = STATS.snapshot()
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))
    dist.destroy_process_group()
""") % {"archs": STEP_ARCHS}


def _procs(cmds, env, deadline):
    """Run processes to their end against one deadline; (code, log)s."""
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return procs, deadline


def _finish(procs, deadline, what):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{what} did not end within {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [log for p, log in zip(procs, logs) if p.returncode != 0]
    assert not bad, f"{what} failed:\n" + bad[0][-4000:]


def _tree_to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the reference on a host mesh, the port's four ranks and the
    reference's one-device steps."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp, out = tmp / "in", tmp / "out"
    inp.mkdir()
    out.mkdir()
    rng = np.random.default_rng(0)
    feed = {}
    for arch in STEP_ARCHS:
        jc, tc = cfgs(arch)
        mod = __import__("repro.models." + ("encdec" if jc.family == "encdec"
                                            else "lm"), fromlist=["init"])
        jp = mod.init(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
        b = batch(jc, seed=0, b=B, s=S)
        state = lm_params_from_numpy(tc, _tree_to_numpy(jp),
                                     device="cpu").state_dict()
        torch.save({"state": state, "batch": b}, inp / f"{arch}.pt")
        feed[arch] = (jc, jp, b)
        if arch == "codeqwen1.5-7b":
            jsave_checkpoint(str(inp / "ref_ckpt"), 0, {
                "params": jp, "opt": jadamw.adamw_init(jp)})
    gcfg = dataclasses.replace(reduced(get_config("granite-moe-1b-a400m")),
                               capacity_factor=4.0)
    moe_p = jlayers.init_moe(jax.random.PRNGKey(0), gcfg, dtype=jnp.float32)
    moe_x = rng.standard_normal((4, 16, gcfg.d_model)).astype(np.float32)
    torch.save({"state": {k: torch.tensor(np.asarray(v))
                          for k, v in moe_p.items()}, "x": moe_x},
               inp / "moe.pt")
    rp = {"h": rng.standard_normal((4, 8, 64)).astype(np.float32),
          "w": (rng.standard_normal((64, 32)) * 0.1).astype(np.float32),
          "ct": rng.standard_normal((4, 8, 32)).astype(np.float32)}
    torch.save(rp, inp / "rp.pt")
    ring = {"x": rng.standard_normal((4, 16, 32)).astype(np.float32),
            "w": (rng.standard_normal((32, 64)) * 0.1).astype(np.float32),
            "psum_g": rng.standard_normal((4, 256)).astype(np.float32)}
    torch.save(ring, inp / "ring.pt")
    np.savez(inp / "ref_inputs.npz", moe_x=moe_x,
             **{f"rp_{k}": v for k, v in rp.items()}, psum_g=ring["psum_g"],
             **{f"b_{k}": v for k, v in feed["granite-moe-1b-a400m"][2]
                .items()})

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    deadline = time.monotonic() + DEADLINE_S
    ref, _ = _procs([[sys.executable, "-c", REFERENCE,
                      str(inp / "ref_inputs.npz"), str(out / "ref.npz"),
                      json.dumps(OPT)]], env, deadline)
    store = str(tmp / "rendezvous")
    ranks, _ = _procs([[sys.executable, "-c", WORKER, str(r), "4", store,
                        str(inp), str(out), json.dumps(OPT)]
                       for r in range(4)], env, deadline)
    one = {}
    for arch in ONE_DEVICE:
        jc, jp, b = feed[arch]
        step = jax.jit(jmake_train_step(jc, JOptConfig(**OPT),
                                        jmake_test_mesh(1, 1)))
        _, st, m = step(jp, jadamw.adamw_init(jp), jbatch(b))
        one[arch] = ({k: float(v) for k, v in m.items()},
                     _tree_to_numpy(st["master"]), _tree_to_numpy(st["mu"]))
    _finish(ranks, deadline, "the port's 2x2 world")
    _finish(ref, deadline, "the reference on a 2x2 host mesh")
    port = [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return {"port": port, "ref": dict(np.load(out / "ref.npz")),
            "one": one, "out": out, "moe_x": moe_x, "rp": rp, "ring": ring}


def _master_ok(port, ref_master, ref_mu, lr):
    """The gathered new master within ``1e-2 * lr`` plus ``lr * |dg| /
    eps`` (dg read off the two mu's, as ``check_step``)."""
    cfg = OptConfig(**OPT)
    pm, pmu = named_to_numpy(port["master"]), named_to_numpy(port["mu"])
    for (path, a), b, mu_p, mu_r in zip(
            jax.tree_util.tree_flatten_with_path(pm)[0],
            jax.tree.leaves(ref_master), jax.tree.leaves(pmu),
            jax.tree.leaves(ref_mu)):
        bound = 1e-2 * lr + lr * np.abs(mu_p - mu_r) / ((1 - cfg.b1) * cfg.eps)
        err = np.abs(a - b)
        assert np.all(err <= bound), (jax.tree_util.keystr(path),
                                      float((err - bound).max()))


def _check_step(world, arch, zero2):
    runs = [r[f"{arch}/{zero2}"] for r in world["port"]]
    # the metrics are the global ones, alike on every rank
    assert len({(r["loss"], r["grad_norm"]) for r in runs}) == 1
    assert all(r["holds"] and r["params_are_master"] for r in runs)
    got = runs[0]
    if arch in world["one"]:
        m, master, mu = world["one"][arch]
    else:
        ref = world["ref"]
        m = {k: float(ref[k]) for k in ("loss", "grad_norm", "lr")}
        keys = sorted(k for k in ref if k.startswith("master"))
        master = named_to_numpy(got["master"])
        flat = jax.tree_util.tree_flatten_with_path(master)[0]
        assert sorted("master" + jax.tree_util.keystr(p)
                      for p, _ in flat) == keys
        treedef = jax.tree.structure(master)
        master = treedef.unflatten([ref["master" + jax.tree_util.keystr(p)]
                                    for p, _ in flat])
        mu = treedef.unflatten([ref["mu" + jax.tree_util.keystr(p)]
                                for p, _ in flat])
    np.testing.assert_allclose(got["loss"], m["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], m["grad_norm"], rtol=1e-4,
                               atol=1e-4)
    _master_ok(got, master, mu, m["lr"])


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_2x2_matches_reference(world, arch):
    """One ZeRO-2 step (gradients reduce-scattered over ``data``) on 2x2:
    every rank holds exactly its ``opt_specs`` slice, and the loss,
    ``grad_norm`` and gathered master agree with the reference's step."""
    _check_step(world, arch, True)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_2x2_zero1_matches_reference(world, arch):
    """The same without ``grad_specs``: gradients all-reduced over
    ``data`` and cut to the ZeRO slice."""
    _check_step(world, arch, False)


def test_moe_a2a_matches_dense_dispatch(world):
    """Each rank's rows within 1e-4 of the dense dispatch (no-drop
    capacity); the aux loss, averaged over ``model`` in the layer and over
    ``data`` by the train step, within 1e-5 of the reference's a2a, which
    averages it over both."""
    ref = world["ref"]
    for r, got in enumerate(world["port"]):
        d = r // 2
        want = ref["moe_dense_y"][2 * d:2 * d + 2]
        np.testing.assert_allclose(got["moe_y"].detach().numpy(), want,
                                   rtol=1e-4, atol=1e-4)
    aux = [got["moe_aux"] for got in world["port"]]
    assert aux[0] == aux[1] and aux[2] == aux[3]
    np.testing.assert_allclose((aux[0] + aux[2]) / 2,
                               float(ref["moe_a2a_aux"]), rtol=1e-5,
                               atol=1e-5)


def test_row_parallel_bf16_reduce_matches_reference(world):
    ref = world["ref"]
    dw = {0: 0.0, 1: 0.0}
    for r, got in enumerate(world["port"]):
        d, m = divmod(r, 2)
        rp = got["rp"]
        assert rp["backward_calls"] == 0
        rows = slice(2 * d, 2 * d + 2)
        cols = slice(32 * m, 32 * m + 32)
        np.testing.assert_allclose(rp["y"].numpy(), ref["rp_y"][rows],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rp["dh"].numpy(),
                                   ref["rp_dh"][rows][..., cols],
                                   rtol=1e-6, atol=1e-6)
        dw[m] = dw[m] + rp["dw"].numpy()
    for m in (0, 1):
        np.testing.assert_allclose(dw[m], ref["rp_dw"][32 * m:32 * m + 32],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_ring_matmul_matches_allgather_matmul(world, mesh):
    ring = world["ring"]
    full = np.einsum("bsd,df->bsf", ring["x"], ring["w"])
    tp = 2 if mesh == "2x2" else 4
    for r, got in enumerate(world["port"]):
        d, m = divmod(r, tp)
        rows = slice(2 * d, 2 * d + 2) if tp == 2 else slice(None)
        cols = slice(64 // tp * m, 64 // tp * (m + 1))
        np.testing.assert_allclose(got["ring_" + mesh].numpy(),
                                   full[rows][..., cols], rtol=1e-5,
                                   atol=1e-5)


def test_quantized_psum_on_four_ranks(world):
    g = world["ring"]["psum_g"]
    ref = world["ref"]["psum"]
    total = g.sum(0)
    for got in world["port"]:
        out = got["psum"].numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        assert float(np.max(np.abs(out - total) / (1 + np.abs(total)))) < 0.05


def test_sharded_save_equals_one_device_save(world):
    """The files of a 2x2 save equal a one-device save of the same
    weights, array for array and manifest for manifest."""
    a, ea = read_manifest_dir(str(world["out"] / "sharded" / "step_00000003"))
    b, eb = read_manifest_dir(str(world["out"] / "one" / "step_00000003"))
    assert ea == eb and set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_elastic_reshard_2x2_to_2x1(world):
    """The 2x2 save restored onto 2x1 by two ranks: each leaf bit-equal to
    its slice, each rank's shapes those of the new specs (the model axis
    gone: full width)."""
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs import reduced as treduced
    from repro_torch.launch import specs

    full = {n: tuple(p.shape) for n, p in specs.params_shape(
        treduced(tget_config("codeqwen1.5-7b"))).named_parameters()}
    for got in world["port"][:2]:
        assert got["reshard_2x1"] is True
        assert got["reshard_2x1_shapes"] == full


def test_reference_file_restores_into_sharded_world(world):
    assert all(got["reference_file"] is True for got in world["port"])


def test_collectives_are_counted(world):
    """Every rank counted its collectives; on the CPU none is staged."""
    for got in world["port"]:
        st = got["stats"]
        assert st["host_staged_bytes"] == 0
        for name in ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "all_to_all_single",
                     "batch_isend_irecv"):
            assert st["calls"].get(name, 0) > 0, name


def test_topk_compression_equals_reference():
    """Sent values, residual and ``sent_density`` exactly the reference's,
    over steps of error feedback."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64,), "b": (8, 8)}
    jstate = jcomp.init_compression({k: jnp.zeros(s) for k, s in
                                     shapes.items()})
    tstate = tcomp.init_compression({k: torch.zeros(s) for k, s in
                                     shapes.items()})
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        js, jstate, jm = jcomp.topk_compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, k_frac=0.05)
        ts, tstate, tm = tcomp.topk_compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            k_frac=0.05)
        assert tm["sent_density"] == jm["sent_density"]
        for k in shapes:
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k]))
            assert np.array_equal(tstate.error[k].numpy(),
                                  np.asarray(jstate.error[k]))


@pytest.mark.parametrize("block", [32, 256])
def test_int8_quantization_equals_reference(block):
    x = np.random.default_rng(block).standard_normal(500).astype(np.float32)
    jq, js, jshape, jpad = jcomp.quantize_int8(jnp.asarray(x), block)
    tq, ts, tshape, tpad = tcomp.quantize_int8(torch.from_numpy(x), block)
    assert (tshape, tpad) == (jshape, jpad)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(
        tcomp.dequantize_int8(tq, ts, tshape, tpad).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, jshape, jpad)))


ENTRY = ["--device", "cpu", "--reduced", "--data-mesh", "2", "--model-mesh",
         "2", "--steps", "6", "--ckpt-every", "2"]


def test_train_main_2x2_recovers_bit_equal(tmp_path, capfd):
    """``main`` spawns four gloo ranks: a fault at step 3 restarts once
    from step 2's checkpoint, the losses are finite, and the final
    checkpoint equals a run without the fault, bit for bit."""
    run = train.main(ENTRY + ["--inject-fault-at", "3",
                              "--ckpt-dir", str(tmp_path / "a")])
    out = capfd.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out and "backend=gloo" in out
    assert run.backend == "gloo" and run.summary["restarts"] == 1
    losses = run.summary["losses"]
    assert len(losses) == 7 and all(np.isfinite(losses))
    clean = train.main(ENTRY + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean.summary["restarts"] == 0
    assert clean.summary["losses"] == losses[:3] + losses[4:]
    a, _ = read_manifest_dir(str(tmp_path / "a" / "step_00000006"))
    b, _ = read_manifest_dir(str(tmp_path / "b" / "step_00000006"))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
