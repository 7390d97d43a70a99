"""The multi-pod dry run (``python -m repro_torch.launch.dryrun``) on the
CPU.  One module fixture starts everything at once, against one deadline:

  * the CLI in four subprocesses: one cell per step kind, shrunk with the
    reference's own ``--set`` overrides, and granite-moe-1b-a400m x
    train_4k x single at full width (the trip counts make it cheap); each
    writes an artifact with the reference's keys (``trace_s`` in place of
    ``lower_s`` / ``compile_s``), and none loads ``jax`` or ``repro``;
  * four ``gloo`` processes on a 2x2 mesh (``WORKER``), which run
    - a reduced granite train step at the dry run's setting (bf16, remat
      on), whose collective calls and bytes on rank 0 must equal those the
      fake world traces on ``meta`` for rank 0 of the same mesh;
    - each family's prefill, and three decode steps on the reference's
      cache layout (``partition.cache_specs``: the KV window split over
      ``model``, the SSM state by heads), against one device from the same
      weights: logits and every new cache slice within 1e-5 (f32), the
      last step at a position past the window (the write clamps to its
      last slot, which one rank holds); an int8 KV cache within 1e-5 too;
      attention whose q heads do not split on whole heads (3 heads, 1 kv
      head over 2 ranks: every leaf gathered) within 1e-5, its train loss
      too; and the repairs of mesh decode (``REPAIR_CASES``): a KV window
      of 7 on model = 2 (whole on every rank, given its layout by
      ``partition.shard_caches``), mamba2 with H = 3 heads and Ch = 128
      conv channels, and each family's prefill on the mesh, its caches in
      ``cache_specs``' layout, grown on the mesh and decoded three steps;
  * the four example twins (``examples/*_torch.py``) with ``--device cpu``
    at their smallest size: the numbers that come from ``repro_torch.core``
    (I/O counts, Theorem-1 bounds, Compact Growth) equal what the same
    calls return here.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis
from repro_torch import core
from repro_torch.core.compact_growth import bandwidth, bandwidth_order
from repro_torch.engine import Engine
from repro_torch.configs import get_config, reduced
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.models.sharding import axes_from_mesh, set_mesh
from repro_torch.sparse import prune_dense_stack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 240.0
TOL = 1e-5
TRAIN_B, TRAIN_S = 8, 16

CELLS = {
    "full": ["--arch", "granite-moe-1b-a400m", "--shape", "train_4k",
             "--mesh", "single"],
    "train": ["--arch", "codeqwen1.5-7b", "--shape", "train_4k", "--mesh",
              "multi", "--set", "n_layers=2"],
    "prefill": ["--arch", "seamless-m4t-medium", "--shape", "prefill_32k",
                "--set", "n_enc_layers=2", "--set", "n_dec_layers=2"],
    "decode": ["--arch", "zamba2-1.2b", "--shape", "long_500k", "--mesh",
               "multi", "--set", "n_layers=7", "--tag", "seven"],
}

EXAMPLES = {
    "quickstart": [],
    "codesign_compact_growth": [],
    "serve_sparse": ["--requests", "8", "--batch", "4", "--reorder-iters",
                     "20"],
    "train_lm": ["--steps", "4"],
}

CLI = textwrap.dedent("""
    import json, runpy, sys
    sys.argv = ["dryrun"] + sys.argv[1:]
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
    print("MODULES " + json.dumps(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))))
""")

#: (name, arch, config changes) of the parity cases
CASES = [
    ("dense", "codeqwen1.5-7b", {}),
    ("dense-int8-kv", "codeqwen1.5-7b", {"kv_quant": True}),
    ("odd-heads", "codeqwen1.5-7b", {"n_heads": 3, "n_kv_heads": 1}),
    ("moe", "granite-moe-1b-a400m", {"capacity_factor": 4.0}),
    ("ssm", "mamba2-1.3b", {}),
    ("hybrid", "zamba2-1.2b", {}),
    ("encdec", "seamless-m4t-medium", {}),
    ("vision", "internvl2-26b", {}),
]

WORKER = textwrap.dedent("""
    import dataclasses, sys
    import torch
    import torch.distributed as dist
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group('gloo', store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import partition, train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import encdec, lm
    from repro_torch.models.sharding import STATS, axes_from_mesh
    from repro_torch.optim import OptConfig
    CASES, TB, TS = %(cases)r, %(tb)d, %(ts)d
    B, P, W = 4, 6, 8              # rows, prompt, KV window
    mesh = make_test_mesh(2, 2).bind()
    one = make_test_mesh(1, 1)
    axes_from_mesh(mesh)
    res = {}

    # the dry run's setting, reduced: granite, bf16, remat on
    cfg = dataclasses.replace(reduced(get_config('granite-moe-1b-a400m')),
                              remat=True)
    params, opt, step = train.build(cfg, mesh, OptConfig(), device='cpu')
    batch = train.make_batches(cfg, TB, TS, 'cpu', mesh=mesh)(0)
    STATS.reset()
    step(params, opt, batch)
    res['stats'] = STATS.snapshot()

    def local(tree, specs):
        if isinstance(tree, dict):
            return {k: local(v, specs[k]) for k, v in tree.items()}
        if tree is None:
            return None
        return partition.local_shard(tree, specs, mesh).clone()

    def err(a, b):
        if isinstance(a, dict):
            return max([err(a[k], b[k]) for k in a] + [0.0])
        if a is None:
            return 0.0
        assert a.shape == b.shape, (a.shape, b.shape)
        return float((a.float() - b.float()).abs().max())

    def rows(x):
        return local(x, partition.batch_specs(mesh, {'x': x})['x'])

    gen = torch.Generator().manual_seed(1)
    for name, arch, changes in CASES:
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        mod = encdec if cfg.family == 'encdec' else lm
        full = mod.init(torch.Generator().manual_seed(0), cfg,
                        dtype=torch.float32)
        split = mod.init(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.float32)
        partition.shard_module(split, partition.params_specs(mesh, split),
                               mesh)
        toks = torch.randint(0, cfg.vocab, (B, P + 4), generator=gen)
        out_name = {}
        if name == 'odd-heads':
            # the mean over this data rank's rows against one device's
            b = {'tokens': rows(toks[:, :P]), 'labels': rows(toks[:, 1:P + 1])}
            lm_, _ = lm.loss_fn(split, cfg, b, mesh)
            l1, _ = lm.loss_fn(full, cfg, b, one)
            out_name['loss'] = abs(float(lm_) - float(l1))
        full.requires_grad_(False)
        split.requires_grad_(False)
        with torch.no_grad():
            if cfg.family == 'encdec':
                src = torch.randn(B, W, cfg.d_model, generator=gen)
                pre = {'src_embeds': src, 'tgt_tokens': toks[:, :P]}
                enc = encdec.encode(full, cfg, src)
                caches = encdec.make_dec_caches(full, cfg, enc, W,
                                                dtype=torch.float32)
                dec = lambda p, t, c, m: encdec.decode_step(p, cfg, t, c, m)
            else:
                pre = ({'embeds': torch.randn(B, P, cfg.d_model,
                                              generator=gen)}
                       if cfg.modality == 'vision_stub'
                       else {'tokens': toks[:, :P]})
                _, caches = lm.prefill(full, cfg, tokens=pre.get('tokens'),
                                       embeds=pre.get('embeds'), mesh=one)
                caches = lm.grow_caches(cfg, caches, W)
                dec = lambda p, t, c, m: lm.decode_step(p, cfg, t, c, m)
            lg1, _ = make_prefill_step(cfg, one)(full, pre)
            lgm, _ = make_prefill_step(cfg, mesh)(
                split, {k: rows(v) for k, v in pre.items()})
            out_name['prefill'] = err(lgm, rows(lg1))
            specs = partition.cache_specs(mesh, cfg, caches)
            mine = local(caches, specs)
            for i in range(3):
                if i == 2:          # a position past the window: it clamps
                    for c in (caches, mine):
                        for sub in c.values():
                            if isinstance(sub, dict) and 'pos' in sub:
                                sub['pos'] = sub['pos'] + W
                tok = toks[:, P + i:P + i + 1]
                lg1, caches = dec(full, tok, caches, one)
                lgm, mine = dec(split, rows(tok), mine, mesh)
                out_name[f'decode{i}'] = err(lgm, rows(lg1))
                out_name[f'caches{i}'] = err(mine, local(caches, specs))
        res[name] = out_name

    # the repaired faults, each against one device from the same weights:
    # a KV window that does not divide model (7 on model = 2, whole on
    # every rank), cut from one device's caches, its last step past the
    # window; an SSM whose heads (3) and conv channels (128) split
    # differently; and each family's prefill on the mesh -> grow_caches ->
    # three decode steps (the window's layout travels as its 'window' leaf)
    def drop(tree):
        if isinstance(tree, dict):
            return {k: drop(v) for k, v in tree.items() if k != 'window'}
        return tree

    def windows(tree, acc):
        for k, v in (tree or {}).items():
            if k == 'window':
                acc.add(v.shape[-1])
            elif isinstance(v, dict):
                windows(v, acc)
        return acc

    def build(arch, changes):
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        mod = encdec if cfg.family == 'encdec' else lm
        full = mod.init(torch.Generator().manual_seed(0), cfg,
                        dtype=torch.float32)
        split = mod.init(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.float32)
        partition.shard_module(split, partition.params_specs(mesh, split),
                               mesh)
        return cfg, mod, full.requires_grad_(False), \
            split.requires_grad_(False)

    def decode3(cfg, mod, full, split, caches, mine, toks, width, out_name):
        specs = partition.cache_specs(mesh, cfg, caches)
        for i in range(3):
            if i == 2:              # a position past the window: it clamps
                for c in (caches, mine):
                    for sub in c.values():
                        if isinstance(sub, dict) and 'pos' in sub:
                            sub['pos'] = sub['pos'] + width
            tok = toks[:, P + i:P + i + 1]
            lg1, caches = mod.decode_step(full, cfg, tok, caches, one)
            lgm, mine = mod.decode_step(split, cfg, rows(tok), mine, mesh)
            out_name[f'decode{i}'] = err(lgm, rows(lg1))
            out_name[f'caches{i}'] = err(drop(mine), local(caches, specs))

    MORE = [('window-7', 'codeqwen1.5-7b', {}, 7),
            ('ssm-h3-ch128', 'mamba2-1.3b',
             {'d_model': 48, 'ssm_headdim': 32}, W)]
    for name, arch, changes, width in MORE:
        cfg, mod, full, split = build(arch, changes)
        toks = torch.randint(0, cfg.vocab, (B, P + 4), generator=gen)
        with torch.no_grad():
            lg1, caches = lm.prefill(full, cfg, tokens=toks[:, :P], mesh=one)
            caches = lm.grow_caches(cfg, caches, width)
            mine = partition.shard_caches(mesh, cfg, caches)
            out_name = {'prefill': 0.0}
            decode3(cfg, mod, full, split, caches, mine, toks, width,
                    out_name)
        res[name] = out_name

    for name, arch, changes, width in (
            [(n + '/mesh-prefill', a, c, W) for n, a, c in CASES]
            + [('window-7/mesh-prefill', 'codeqwen1.5-7b', {}, 7)]):
        cfg, mod, full, split = build(arch, changes)
        toks = torch.randint(0, cfg.vocab, (B, P + 4), generator=gen)
        with torch.no_grad():
            if cfg.family == 'encdec':
                src = torch.randn(B, W, cfg.d_model, generator=gen)
                pre = {'src_embeds': src, 'tgt_tokens': toks[:, :P]}
                lg1, enc1 = make_prefill_step(cfg, one)(full, pre)
                caches = encdec.make_dec_caches(full, cfg, enc1, width,
                                                dtype=torch.float32)
                lgm, encm = make_prefill_step(cfg, mesh)(
                    split, {k: rows(v) for k, v in pre.items()})
                mine = encdec.make_dec_caches(split, cfg, encm, width,
                                              dtype=torch.float32, mesh=mesh)
            else:
                pre = ({'embeds': torch.randn(B, P, cfg.d_model,
                                              generator=gen)}
                       if cfg.modality == 'vision_stub'
                       else {'tokens': toks[:, :P]})
                lg1, caches = make_prefill_step(cfg, one)(full, pre)
                caches = lm.grow_caches(cfg, caches, width)
                lgm, mine = make_prefill_step(cfg, mesh)(
                    split, {k: rows(v) for k, v in pre.items()})
                mine = lm.grow_caches(cfg, mine, width, mesh=mesh)
            out_name = {'prefill': err(lgm, rows(lg1))}
            specs = partition.cache_specs(mesh, cfg, caches)
            out_name['grown'] = err(drop(mine), local(caches, specs))
            want = set() if cfg.family == 'ssm' else {width}
            out_name['window'] = float(windows(mine, set()) != want)
            decode3(cfg, mod, full, split, caches, mine, toks, width,
                    out_name)
        res[name] = out_name
    torch.save(res, f'{out}/rank{rank}.pt')
    dist.destroy_process_group()
""") % {"cases": CASES, "tb": TRAIN_B, "ts": TRAIN_S}


def _granite_cfg():
    return dataclasses.replace(reduced(get_config("granite-moe-1b-a400m")),
                               remat=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    art, out = tmp / "artifacts", tmp / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN_DIR=str(art), OMP_NUM_THREADS="1")
    env["TMPDIR"] = str(tmp)
    procs = {k: subprocess.Popen([sys.executable, "-c", CLI, *args], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, args in CELLS.items()}
    for name, args in EXAMPLES.items():
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples",
                                          f"{name}_torch.py"),
             "--device", "cpu", *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    store = str(tmp / "rendezvous")
    for r in range(4):
        procs[f"rank{r}"] = subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), "4", store, str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    deadline = time.monotonic() + DEADLINE_S
    expected = _expected_core_lines()
    logs = {}
    try:
        for k, p in procs.items():
            logs[k] = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))[0]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the dry run's processes did not end within "
                    f"{DEADLINE_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = {k: p.returncode for k, p in procs.items()}
    ranks = [torch.load(out / f"rank{r}.pt") if codes[f"rank{r}"] == 0
             else None for r in range(4)]
    return {"codes": codes, "logs": logs, "art": art, "ranks": ranks,
            "expected": expected}


def _artifact(run, kind):
    args = CELLS[kind]
    arch, shape = args[args.index("--arch") + 1], args[args.index("--shape")
                                                       + 1]
    mesh = "2_16_16" if "multi" in args else "16_16"
    tag = f"-{args[args.index('--tag') + 1]}" if "--tag" in args else ""
    with open(run["art"] / f"{arch}--{shape}--{mesh}{tag}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("kind", list(CELLS))
def test_cli_cell_writes_the_reference_keys(run, kind):
    assert run["codes"][kind] == 0, run["logs"][kind][-4000:]
    log = run["logs"][kind]
    assert "all 1 dry-run cells compiled OK" in log
    assert "MODULES []" in log, "the dry run loaded jax or repro"
    res = _artifact(run, kind)
    assert set(res) == {"arch", "shape", "mesh", "chips", "status",
                        "trace_s", "memory", "roofline"}
    assert set(res["memory"]) == {"argument_bytes_per_dev",
                                  "output_bytes_per_dev",
                                  "temp_bytes_per_dev",
                                  "peak_est_bytes_per_dev"}
    assert set(res["roofline"]) == {
        f.name for f in dataclasses.fields(hlo_analysis.Roofline)}
    m, rl = res["memory"], res["roofline"]
    assert res["status"] == "ok"
    assert res["chips"] == (512 if "multi" in CELLS[kind] else 256)
    assert m["peak_est_bytes_per_dev"] == \
        m["argument_bytes_per_dev"] + m["temp_bytes_per_dev"]
    assert rl["flops_per_dev"] > 0 and rl["dominant"] in (
        "compute", "memory", "collective")
    assert rl["compute_s"] == rl["flops_per_dev"] / ca.PEAK_FLOPS


def test_full_width_granite_train_cell(run):
    """granite-moe-1b-a400m x train_4k on 16x16: the microbatches and the
    chunk pairs trip-counted, every collective of the step counted."""
    res = _artifact(run, "full")
    rl = res["roofline"]
    assert set(rl["coll_by_op"]) == {"all-gather", "all-reduce",
                                     "all-to-all", "reduce-scatter"}
    assert rl["dominant"] == "collective"
    assert res["trace_s"] < 120


def test_fake_world_counts_what_gloo_counts(run):
    """A reduced granite 2x2 step: the fake world's trace on meta against
    rank 0 of four gloo processes."""
    assert run["codes"]["rank0"] == 0, run["logs"]["rank0"][-4000:]
    gloo = run["ranks"][0]["stats"]
    with dryrun.fake_world(4):
        mesh = make_test_mesh(2, 2).bind()
        axes_from_mesh(mesh)
        set_mesh(mesh)
        step, args = dryrun.build_cell(
            _granite_cfg(), ShapeConfig("t", TRAIN_S, TRAIN_B, "train"), mesh)
        cost, _ = ca.analyze_step(step, *args)
    assert cost.coll_calls == {ca.HLO_NAMES[k]: v
                               for k, v in gloo["calls"].items()}
    assert cost.coll_by_op == {ca.HLO_NAMES[k]: v
                               for k, v in gloo["bytes"].items()}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_steps_on_the_reference_cache_layout_match_one_device(run,
                                                                   name):
    for r in range(4):
        assert run["codes"][f"rank{r}"] == 0, \
            run["logs"][f"rank{r}"][-4000:]
        errs = run["ranks"][r][name]
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        assert not bad, f"rank {r}: {bad}"
        assert {"prefill", "decode2", "caches2"} <= set(errs)


#: the repairs' cases (``WORKER``): a whole window cut from one device, an
#: SSM whose state and conv split differently, and each family's (and the
#: whole window's) prefill on the mesh -> grow_caches -> decode
REPAIR_CASES = (["window-7", "ssm-h3-ch128", "window-7/mesh-prefill"]
                + [c[0] + "/mesh-prefill" for c in CASES])


@pytest.mark.parametrize("name", REPAIR_CASES)
def test_mesh_decode_repairs_match_one_device(run, name):
    for r in range(4):
        assert run["codes"][f"rank{r}"] == 0, \
            run["logs"][f"rank{r}"][-4000:]
        errs = run["ranks"][r][name]
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        assert not bad, f"rank {r}: {bad}"
        assert {"prefill", "decode2", "caches2"} <= set(errs)
        if name.endswith("/mesh-prefill"):
            assert {"grown", "window"} <= set(errs)


# --------------------------------------------------------------------------- #
# the example twins
# --------------------------------------------------------------------------- #

def _expected_core_lines():
    """The lines of the example twins that come from ``repro_torch.core``,
    from the same calls here (the twins print them as the reference's
    examples do)."""
    q = []
    net = core.random_ffnn(width=200, depth=4, density=0.1, seed=0)
    b = core.theorem1_bounds(net)
    q.append(f"W={net.W} N={net.N} I={net.I} S={net.S}")
    q.append(f"total I/O bounds: {b.total_lo} <= IOs <= {b.total_hi} ")
    order = net.theorem1_order()
    for policy in ("min", "lru", "rr"):
        st = core.simulate(net, order, 64, policy)
        q.append(f"  {policy.upper():3s}: reads={st.reads} "
                 f"writes={st.writes} total={st.total}")
    res = core.connection_reordering(net, order, 64, T=2000, seed=0)
    q.append(f"  {res.initial_ios} -> {res.ios} I/Os ")
    cg = core.generate(M_g=64, n_iters=400, in_degree=4, seed=1)
    bb = core.theorem1_bounds(cg.net)
    st = core.simulate(cg.net, cg.order, 64, "min")
    q.append(f"  grown net: W={cg.net.W} N={cg.net.N}; IOs={st.total} "
             f"== lower bound {bb.total_lo}: {st.total == bb.total_lo}")
    c = []
    for Mg in (50, 100, 200):
        cg = core.generate(M_g=Mg, n_iters=500, in_degree=4, seed=Mg)
        b = core.theorem1_bounds(cg.net)
        at_half = core.simulate(cg.net, cg.order, max(3, Mg // 2),
                                "min").total
        at_m = core.simulate(cg.net, cg.order, Mg, "min").total
        c.append(f"M_g={Mg:4d}   W={cg.net.W:5d} N={cg.net.N:5d}  "
                 f"{at_half:8d} {at_m:8d} {b.total_lo:8d}   "
                 f"{at_m == b.total_lo}")
    cg = core.generate(M_g=60, n_iters=300, in_degree=3, seed=7)
    order, m_needed = bandwidth_order(cg.net)
    st = core.simulate(cg.net, order, m_needed, "min")
    b = core.theorem1_bounds(cg.net)
    c.append(f"bandwidth k={bandwidth(cg.net)}; with M=k+2={m_needed}: "
             f"IOs={st.total} (lower bound {b.total_lo}) "
             f"optimal={st.total == b.total_lo}")
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((1024, 4096)).astype(np.float32) * 0.03
    w2 = rng.standard_normal((4096, 1024)).astype(np.float32) * 0.03
    layers = prune_dense_stack([w1, w2], [np.zeros(4096, np.float32),
                                          np.zeros(1024, np.float32)],
                               density=0.1, block_m=128, block_n=128)
    plan = Engine(activation="gelu", reorder=True, reorder_iters=20,
                  device="cpu").compile(layers)
    io = plan.describe().split("; ")[1]
    return {"quickstart": q, "codesign_compact_growth": c,
            "serve_sparse": [io], "train_lm": []}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_twin_prints_the_core_numbers(run, name):
    assert run["codes"][name] == 0, run["logs"][name][-4000:]
    log = run["logs"][name]
    for line in run["expected"][name]:
        assert line in log, f"{name}: {line!r} not in its output"
    last = {"quickstart": "quickstart OK",
            "codesign_compact_growth": "co-design example OK",
            "serve_sparse": "output sample:",
            "train_lm": "steps=4 "}[name]
    assert last in log
    if name == "quickstart":
        assert "megakernel launches: 0" in log      # plain version on CPU
