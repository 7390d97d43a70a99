"""The gated-FFN configuration through the harness on the CPU: a small
``sparse_glu_ffn`` cell added the way a later change adds one, its plain
reference (``reference_glu``) against the tests' copy and the port's plain
backend, the work it counts, and what it imports."""

import ast
import importlib.util
import json

import numpy as np
import pytest
import torch

from sparsebench import reference_glu, work
from sparsebench.cli import result, run_cell
from sparsebench.models.sparse_glu_ffn import Model
from sparsebench.outcome import Run
from sparsebench.spec import ROOT, load_cell
from sparsebench.testing import TINY_LIMIT, tiny_root

TINY_GLU = {
    "name": "tiny-glu", "source": "https://arxiv.org/abs/2301.01048",
    "model": "sparse_glu_ffn", "sizes": [128, 512, 128], "density": 0.25,
    "layout_seed": 0, "block": 32, "hidden_act": "silu",
    "final_activation": "none", "reorder_iters": 50, "reorder_seed": 0,
    "gate_up_std": 0.177, "down_std": 0.088, "dtype": "float32",
    "reduced": [],
}
CELL = "tiny-glu.tiny-offline"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout, with the small GLU cell's files and entries
    added."""
    top = tiny_root(tmp_path_factory.mktemp("checkout"))
    (top / "bench" / "configs" / "tiny-glu.json").write_text(
        json.dumps(TINY_GLU))
    (top / "bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"max_err_rel": TINY_LIMIT}))
    bench = json.loads((top / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-glu", "source": TINY_GLU["source"],
        "file": "bench/configs/tiny-glu.json", "reduced": [],
        "why": "a small gated FFN for the CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-glu",
                               "traffic": "tiny-offline", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "minicpm-sala-ffn.offline-4096" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (top / "BENCHMARK.json").write_text(json.dumps(bench))
    return top


def run(root, trace=False, control=None, seed=2**31 + 11):
    cell = load_cell(CELL, root)
    r = Run(seed=seed, seconds=0.5, trace=trace, device=torch.device("cpu"),
            t_process=0.0, control=control)
    out = run_cell(cell, r)
    return result(cell, r, out), out


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_glu_cell_runs_end_to_end(root, trace):
    line, out = run(root, trace=trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = load_cell(CELL, root)
    wanted = {m["name"] for m in (cell.per_layer if trace
                                  else cell.end_to_end)}
    assert set(line["metrics"]) <= wanted
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "rows_per_s"}
    else:
        # the plain version on the CPU launches nothing: no pair steps
        assert "glu_pair_steps.offline" in wanted
        assert "glu_pair_steps.offline" not in line["metrics"]
    assert line["compared"]["max_err_rel"]["value"] < TINY_LIMIT / 10


def test_tiny_glu_control_fails_the_comparison(root):
    line, _ = run(root, control="tf32")
    assert line["correct"] is False
    assert line["compared"]["max_err_rel"]["value"] > 10 * TINY_LIMIT


def test_forward_work_counts_both_blocks_of_a_pair():
    """FLOPs 2 rows b^2 (2 live pairs + live down blocks); bytes count the
    gate's and the up's bias once each."""
    model = Model(TINY_GLU, seed=7, device="cpu")
    ref = model.reference()
    x = torch.randn(16, 128, generator=torch.Generator().manual_seed(3))
    inputs = ref.layer_inputs(x)
    got = work.forward_work(inputs, ref.masks, 32)
    pair, down = (reference_glu.pair_mask(*model.weights[:2], 32, 0.25),
                  ref.masks[1])
    live_hidden = work.live_tiles(inputs[1], 32)
    blocks = 2 * int(pair.sum()) + int(down[live_hidden].sum())
    assert pair.sum() == round(0.25 * 4 * 16)
    assert got["flops"] == 2 * 16 * 32 * 32 * blocks
    assert got["live_blocks"] == blocks
    assert got["bytes"] == 4 * (16 * 128 * 2 + 32 * 32 * blocks
                                + 2 * 512 + 128)


def _tests_reference():
    spec = importlib.util.spec_from_file_location(
        "glu_reference", ROOT / "tests" / "glu_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_matches_the_tests_copy_and_the_ports_plain_backend():
    from repro_torch import Engine

    model = Model(TINY_GLU, seed=2**31 + 5, device="cpu")
    ref = model.reference()
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(9))
    want = ref(x)
    copy = _tests_reference().GLUReference(*model.weights, *model.biases, 32,
                                           0.25)
    np.testing.assert_array_equal(copy.pair_mask,
                                  ref.masks[0][:, :ref.masks[0].shape[1] // 2])
    np.testing.assert_array_equal(copy.down_mask, ref.masks[1])
    torch.testing.assert_close(copy(x), want, rtol=1e-6, atol=1e-6)
    layers = model.program_layers()
    kept = np.zeros_like(copy.pair_mask)
    kept[layers[0].rows, layers[0].cols] = True
    np.testing.assert_array_equal(kept, copy.pair_mask)
    plan = Engine(backend="torch", activation="silu", reorder=True,
                  reorder_iters=50, device="cpu").compile(layers)
    scale = want.pow(2).mean().sqrt()
    assert float((plan(x) - want).abs().max() / scale) < 1e-5
    assert float((ref(x, "tf32") - want).abs().max() / scale) > 1e-4


def test_model_fails_at_once_without_the_programs_pair_layer(monkeypatch):
    """A program that has no pair layer (the tree before it) fails the
    cell before any weight is drawn."""
    import repro_torch.sparse

    monkeypatch.delattr(repro_torch.sparse, "prune_glu_ffn")
    drawn = []
    monkeypatch.setattr(torch, "randn", lambda *a, **k: drawn.append(a))
    with pytest.raises(ImportError):
        Model(TINY_GLU, seed=1, device="cpu")
    assert drawn == []


def test_reference_imports_nothing_of_the_program_or_jax():
    tree = ast.parse((ROOT / "bench" / "sparsebench" / "reference_glu.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.module == "reference"
                continue
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "numpy", "torch"}
