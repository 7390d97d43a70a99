"""The port's copied modules and its import boundary.

``repro_torch.core``, ``repro_torch.obs.{trace,series,telemetry,prom}`` and
``repro_torch.serving.{resilience,http}`` are verbatim copies of the
reference's modules, so the Theorem-1 order, Connection Reordering at a
given seed, ``simulate``, ``theorem1_bounds``, the resilience machinery, the
front door and the Prometheus exposition agree by construction; the port
imports neither ``jax`` nor ``ml_dtypes`` nor anything of ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.convert import layers_from_numpy

ROOT = Path(__file__).resolve().parents[1]
COPIES = [f"core/{name}" for name in (
    "__init__.py", "graph.py", "iosim.py", "_iosim_c.py", "bounds.py",
    "reorder.py", "blocksparse.py", "compact_growth.py")] + [
    "obs/trace.py", "obs/series.py", "obs/telemetry.py", "obs/prom.py",
    "serving/resilience.py", "serving/http.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    ref = (ROOT / "src" / "repro" / rel).read_bytes()
    port = (ROOT / "src" / "repro_torch" / rel).read_bytes()
    assert port == ref


def test_import_leaves_out_jax_and_repro():
    """Importing every port module, and chip_smoke.py, loads no jax and no
    module of the reference package."""
    code = (
        "import importlib.util, sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.kernels\n"
        "import repro_torch.kernels._build, repro_torch.kernels.moe_ffn\n"
        "import repro_torch.obs, repro_torch.checkpoint\n"
        "import repro_torch.serving, repro_torch.serving.plancache\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("seed", [0, 5])
def test_schedule_order_and_reordering_agree(make_stack, seed):
    jl = make_stack(sizes=(128, 256, 128), density=0.4, block=32, seed=seed)
    tl = layers_from_numpy(jl)
    jb, tb = jcore.to_block_ffnn(jl), tcore.to_block_ffnn(tl)
    jo, to = jb.net.theorem1_order(), tb.net.theorem1_order()
    np.testing.assert_array_equal(jo, to)
    jr = jcore.connection_reordering(jb.net, jo, M=3, T=200, seed=seed)
    tr = tcore.connection_reordering(tb.net, to, M=3, T=200, seed=seed)
    np.testing.assert_array_equal(jr.order, tr.order)
    js, ts = jcore.simulate(jb.net, jr.order, 3), tcore.simulate(tb.net, tr.order, 3)
    assert (js.reads, js.writes) == (ts.reads, ts.writes)
    jbd, tbd = jcore.theorem1_bounds(jb.net), tcore.theorem1_bounds(tb.net)
    assert vars(jbd) == vars(tbd)


def test_converter_keeps_fields_and_dtypes(make_stack):
    jl = make_stack(sizes=(64, 128, 64), density=0.5, block=32, seed=2)
    tl = layers_from_numpy(jl)
    for a, b in zip(jl, tl):
        assert isinstance(b, tcore.BSRLayer)
        assert (a.n_in, a.n_out, a.block_m, a.block_n) == \
            (b.n_in, b.n_out, b.block_m, b.block_n)
        for name in ("rows", "cols", "blocks", "bias"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert b.rows.dtype == np.int32 and b.blocks.dtype == np.float32
