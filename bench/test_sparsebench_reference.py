"""The plain reference against the port's plain ``torch`` backend on the
CPU, on a few rows of each configuration at its full widths, and what the
reference may import."""

import ast
import json

import numpy as np
import pytest
import torch

from sparsebench.models.sparse_ffnn import Model
from sparsebench.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.parametrize("name", ["bert-ffnn", "random-mlp-512x5"])
def test_reference_matches_the_ports_plain_backend(name):
    from repro_torch import Engine

    config = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                        .read_text())
    model = Model(config, seed=2**31 + 5, device="cpu")
    layers = model.program_layers()
    ref = model.reference()
    # both sides prune to the same blocks
    for lay, mask in zip(layers, ref.masks):
        kept = np.zeros_like(mask)
        kept[lay.rows, lay.cols] = True
        np.testing.assert_array_equal(kept, mask)
    final = config["final_activation"]
    engine = Engine(backend="torch", activation=config["activation"],
                    final_activation=None if final == "none" else final,
                    reorder=True, reorder_iters=config["reorder_iters"],
                    seed=config["reorder_seed"], device="cpu")
    x = torch.randn(8, model.n_in, generator=torch.Generator().manual_seed(9))
    y = engine.compile(layers)(x)
    want = ref(x)
    # f32 sums in another order: a few ulps of the output's scale
    scale = want.pow(2).mean().sqrt()
    assert float((y - want).abs().max() / scale) < 1e-5
    # the control is far off
    assert float((ref(x, "tf32") - want).abs().max() / scale) > 1e-4


def test_reference_imports_nothing_of_the_program_or_jax():
    tree = ast.parse((ROOT / "bench" / "sparsebench" / "reference.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "the reference imports nothing relative"
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch"}
