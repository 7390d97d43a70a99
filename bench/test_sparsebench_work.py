"""FLOP and byte counts of both configurations against hand counts."""

import json

import numpy as np
import pytest
import torch

from sparsebench import reference, work
from sparsebench.models.sparse_ffnn import Model
from sparsebench.spec import ROOT

# (config, nonzero blocks per layer, FLOPs and bytes of a 4096-row call)
HAND = {
    # 2 * 4096 * 128^2 * (26 + 26); x and y 4096 x 1024 f32 each, 52
    # blocks of 128^2 f32, biases 4096 + 1024 f32
    "bert-ffnn": ([26, 26], 6_979_321_856,
                  2 * 4096 * 1024 * 4 + 52 * 128 * 128 * 4 + 5120 * 4),
    # 2 * 4096 * 64^2 * 4 * 6; x and y 4096 x 512 f32, 24 blocks of 64^2
    # f32, biases 4 * 512 f32
    "random-mlp-512x5": ([6, 6, 6, 6], 805_306_368,
                         2 * 4096 * 512 * 4 + 24 * 64 * 64 * 4 + 2048 * 4),
}


def _config(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(HAND))
def test_counts_match_hand_counts(name):
    blocks, flops, nbytes = HAND[name]
    model = Model(_config(name), seed=3, device="cpu")
    ref = model.reference()
    assert [int(m.sum()) for m in ref.masks] == blocks
    x = torch.randn(4096, model.n_in,
                    generator=torch.Generator().manual_seed(0))
    w = work.forward_work(ref.layer_inputs(x), ref.masks, model.block)
    # nonzero biases leave no hidden tile dead: every block is live
    assert w["live_blocks"] == sum(blocks)
    assert w["flops"] == flops
    assert w["bytes"] == nbytes


def test_dead_input_tiles_drop_their_blocks():
    model = Model(_config("bert-ffnn"), seed=4, device="cpu")
    ref = model.reference()
    x = torch.randn(256, 1024, generator=torch.Generator().manual_seed(1))
    dead = [0, 3, 5, 6]
    x.view(256, 8, 128)[:, dead] = 0
    w = work.forward_work(ref.layer_inputs(x), ref.masks, 128)
    live0 = int(np.delete(ref.masks[0], dead, axis=0).sum())
    assert w["live_blocks"] == live0 + int(ref.masks[1].sum())
    assert w["flops"] == 2 * 256 * 128 * 128 * w["live_blocks"]


def test_bound_of_bert_is_compute():
    blocks, flops, nbytes = HAND["bert-ffnn"]
    peak = work.PEAKS["NVIDIA H100 80GB HBM3"]
    bound = work.bound_s({"flops": flops, "bytes": nbytes}, peak)
    assert bound == pytest.approx(flops / 67e12)
    assert bound * 1e6 == pytest.approx(104.2, abs=0.1)


def test_mask_keeps_the_heaviest_blocks():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    w[:64, 64:128] *= 100                      # the heaviest block
    mask = reference.block_mask(w, 64, 1 / 16)
    assert mask.sum() == 1 and mask[0, 1]


@pytest.mark.parametrize("name", sorted(HAND))
def test_every_seed_prunes_to_the_configurations_layout(name):
    masks = [Model(_config(name), seed, "cpu").reference().masks
             for seed in (1, 2**31 + 11)]
    for a, b in zip(*masks):
        np.testing.assert_array_equal(a, b)
