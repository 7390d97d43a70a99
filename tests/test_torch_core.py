"""The port's copied modules and its import boundary.

``repro_torch.core``, ``repro_torch.obs.{trace,series,telemetry,prom}`` and
``repro_torch.serving.{resilience,http}`` are verbatim copies of the
reference's modules, so the Theorem-1 order, Connection Reordering at a
given seed, ``simulate``, ``theorem1_bounds``, the resilience machinery, the
front door and the Prometheus exposition agree by construction; the model
config, the architecture registry, the data pipeline's classes and the
fault-tolerance module are copies whose only changes are import lines; the
port imports neither ``jax`` nor ``ml_dtypes`` nor anything of ``repro``.
"""

import ast
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


# copies whose only change is the package name on their import lines
IMPORT_COPIES = ["models/config.py"] + sorted(
    f"configs/{f.name}" for f in (ROOT / "src" / "repro" / "configs").glob("*.py"))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    ref = (ROOT / "src" / "repro" / rel).read_bytes()
    port = (ROOT / "src" / "repro_torch" / rel).read_bytes()
    assert port == ref


@pytest.mark.parametrize("rel", IMPORT_COPIES)
def test_copy_differs_only_in_import_lines(rel):
    """The model config and the architecture registry: every line equal to
    the reference's, except imports of ``repro.`` that name
    ``repro_torch.`` instead."""
    ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    port = (ROOT / "src" / "repro_torch" / rel).read_text().splitlines()
    assert len(port) == len(ref)
    changed = [(a, b) for a, b in zip(ref, port) if a != b]
    assert changed, "expected the import of the registry to change"
    for a, b in changed:
        assert a.lstrip().startswith(("import repro.", "from repro.")), a
        assert b == a.replace("repro.", "repro_torch.", 1), (a, b)


# copies whose imports differ (the reference's name jax or repro), with the
# last line of the copied part: the data pipeline's numpy classes (its
# ``sharded_batches`` is the port's own) and the fault-tolerance module
CODE_COPIES = {"data/pipeline.py": "def sharded_batches(",
               "runtime/failure.py": None}


def _code_lines(path, until):
    """The lines after the module docstring, without import lines, up to
    (not including) the first line that starts with ``until``."""
    text = path.read_text()
    body = text[text.index('"""', 3) + 3:].splitlines()
    if until is not None:
        body = body[:next(i for i, line in enumerate(body)
                          if line.startswith(until))]
    return [line for line in body
            if not line.startswith(("import ", "from "))]


@pytest.mark.parametrize("rel", sorted(CODE_COPIES))
def test_copy_differs_only_in_imports(rel):
    """Every line of the copied part equal to the reference's, apart from
    the import lines; the port's import neither jax nor repro."""
    until = CODE_COPIES[rel]
    assert _code_lines(ROOT / "src" / "repro_torch" / rel, until) == \
        _code_lines(ROOT / "src" / "repro" / rel, until)
    imports = [line for line in
               (ROOT / "src" / "repro_torch" / rel).read_text().splitlines()
               if line.startswith(("import ", "from "))]
    assert imports and not any(
        line.split()[1].split(".")[0] in ("jax", "repro") for line in imports)


def _example_imports():
    """The modules the example twins import (read off their source: a twin
    runs when imported)."""
    mods = set()
    for path in sorted((ROOT / "examples").glob("*_torch.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module)
    return sorted(mods)


def test_import_leaves_out_jax_and_repro():
    """Importing every port module, chip_smoke.py and everything the example
    twins import loads no jax and no module of the reference package."""
    twins = _example_imports()
    assert len(list((ROOT / "examples").glob("*_torch.py"))) == 4
    assert not [m for m in twins if m.split(".")[0] in ("jax", "repro")]
    code = (
        "import importlib.util, sys\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.cost_analysis\n"
        "import repro_torch.models.tripcount\n"
        + "".join(f"import {m}\n" for m in twins) +
        "import repro_torch, repro_torch.launch.serve, repro_torch.kernels\n"
        "import repro_torch.kernels._build, repro_torch.kernels.moe_ffn\n"
        "import repro_torch.obs, repro_torch.checkpoint\n"
        "import repro_torch.serving, repro_torch.serving.plancache\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.runtime, repro_torch.data\n"
        "import repro_torch.launch.mesh, repro_torch.launch.partition\n"
        "import repro_torch.launch.specs, repro_torch.models.sharding\n"
        "import repro_torch.runtime.compression, repro_torch.runtime.elastic\n"
        "import repro_torch.runtime.overlap\n"
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
