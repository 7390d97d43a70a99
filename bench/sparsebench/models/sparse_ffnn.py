"""A block-pruned sparse FFNN: the weights of a configuration, the program's
net built from them, and the plain reference built from the same weights.

The dense weights are drawn from the seed on the device, in one call, then
handed to both sides as host arrays: the program prunes them with its own
``prune_dense_stack``, the reference (``sparsebench.reference``) prunes them
again itself.

Which blocks survive pruning is the configuration's, as a deployed pruned
model has one sparsity pattern: ``layout_seed`` draws, per layer, the
``round(density * blocks)`` blocks that keep their full scale, and every
other block is scaled by ``OFF_LAYOUT``, so block-magnitude pruning keeps
exactly those.  The values come from the run's seed.  So every seed runs
the same schedule and the same work, in other numbers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import reference

#: scale of the blocks outside the layout: far below the kept blocks' mass
OFF_LAYOUT = 0.01


class Model:
    def __init__(self, config: Dict, seed: int, device):
        self.config = config
        self.device = torch.device(device)
        if config.get("dtype", "float32") != "float32":
            raise ValueError("sparse_ffnn runs float32 configurations")
        self.sizes: List[int] = list(config["sizes"])
        self.block = int(config["block"])
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        shapes = list(zip(self.sizes[:-1], self.sizes[1:]))
        # one draw for every weight, then one for every bias
        ws = torch.randn(sum(a * b for a, b in shapes), generator=self.gen,
                         dtype=torch.float32, device=self.device)
        bs = torch.randn(sum(b for _, b in shapes), generator=self.gen,
                         dtype=torch.float32, device=self.device)
        ws = (ws * float(config["weight_std"])).cpu()
        bs = (bs * float(config["bias_std"])).cpu()
        self.weights = [
            p.reshape(a, b).numpy() * self._layout(k, a, b)
            for k, (p, (a, b)) in enumerate(zip(
                torch.split(ws, [a * b for a, b in shapes]), shapes))]
        self.biases = [p.numpy() for p in
                       torch.split(bs, [b for _, b in shapes])]

    def _layout(self, layer: int, n_in: int, n_out: int) -> np.ndarray:
        """float32 [n_in, n_out]: 1 on the layout's blocks, ``OFF_LAYOUT``
        elsewhere."""
        gi, go = n_in // self.block, n_out // self.block
        keep = max(1, int(round(self.config["density"] * gi * go)))
        rng = np.random.default_rng([int(self.config["layout_seed"]), layer])
        scale = np.full(gi * go, OFF_LAYOUT, np.float32)
        scale[rng.choice(gi * go, keep, replace=False)] = 1.0
        return np.repeat(np.repeat(scale.reshape(gi, go), self.block, 0),
                         self.block, 1)

    @property
    def n_in(self) -> int:
        return self.sizes[0]

    def program_layers(self):
        """The program's block-sparse layers (its own pruning)."""
        from repro_torch.sparse import prune_dense_stack

        return prune_dense_stack(self.weights, self.biases,
                                 density=self.config["density"],
                                 block_m=self.block, block_n=self.block)

    def engine(self):
        """The program's engine as the configuration states it: the
        hand-written kernels, fused, Connection Reordering on."""
        from repro_torch import Engine

        final = self.config["final_activation"]
        return Engine(backend="kernel", activation=self.config["activation"],
                      final_activation=None if final == "none" else final,
                      reorder=True,
                      reorder_iters=int(self.config["reorder_iters"]),
                      seed=int(self.config["reorder_seed"]), fuse=True,
                      device=self.device)

    def reference(self) -> reference.SparseFFNN:
        return reference.SparseFFNN(
            self.weights, self.biases, self.block, self.config["density"],
            self.config["activation"], self.config["final_activation"],
            self.device)
