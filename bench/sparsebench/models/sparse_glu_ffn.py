"""A block-pruned gated (SwiGLU) FFN: the weights of a configuration, the
program's net built from them, and the plain reference built from the same
weights.

``sizes`` is ``[n, f, n]``: gate and up ``[n, f]``, down ``[f, n]``.  The
dense weights are drawn from the seed on the device, in one call, then
handed to both sides as host arrays: the program prunes them with its own
``prune_glu_ffn``, the reference (``sparsebench.reference_glu``) prunes them
again itself.

Which blocks survive pruning is the configuration's, as in
``sparse_ffnn``: ``layout_seed`` draws one pair layout, the
``round(density * blocks)`` (gate, up) block pairs that keep their full
scale, and one layout of the down matrix; every other block of gate and up
alike, and of down, is scaled by ``OFF_LAYOUT``, so that pruning keeps
exactly the layouts.  The values come from the run's seed.  Biases are
zero unless ``bias_std`` says otherwise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import reference_glu
from .sparse_ffnn import OFF_LAYOUT


class Model:
    def __init__(self, config: Dict, seed: int, device):
        # the program's pair layer first: a program without one fails here,
        # before anything is drawn
        from repro_torch.sparse import prune_glu_ffn

        self._prune = prune_glu_ffn
        self.config = config
        self.device = torch.device(device)
        if config.get("dtype", "float32") != "float32":
            raise ValueError("sparse_glu_ffn runs float32 configurations")
        n, f, n_out = (int(v) for v in config["sizes"])
        if n_out != n:
            raise ValueError("sizes must be [n, f, n]")
        self.sizes = [n, f, n]
        self.block = int(config["block"])
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        shapes = [(n, f), (n, f), (f, n)]
        stds = [float(config["gate_up_std"])] * 2 + [float(config["down_std"])]
        # one draw for every weight, then one for every bias
        ws = torch.randn(sum(a * b for a, b in shapes), generator=self.gen,
                         dtype=torch.float32, device=self.device)
        ws = torch.split(ws, [a * b for a, b in shapes])
        pair = self._layout(0, n, f)
        layouts = [pair, pair, self._layout(1, f, n)]
        self.weights = [
            (p.reshape(a, b) * s).cpu().numpy() * lay
            for p, (a, b), s, lay in zip(ws, shapes, stds, layouts)]
        del ws
        bias_std = float(config.get("bias_std", 0.0))
        if bias_std:
            bs = torch.randn(2 * f + n, generator=self.gen,
                             dtype=torch.float32, device=self.device)
            self.biases = [p.cpu().numpy() for p in
                           torch.split(bs * bias_std, [f, f, n])]
        else:
            self.biases = [np.zeros(m, np.float32) for m in (f, f, n)]

    def _layout(self, layer: int, n_in: int, n_out: int) -> np.ndarray:
        """float32 [n_in, n_out]: 1 on the layout's blocks, ``OFF_LAYOUT``
        elsewhere (layer 0: the pair layout of gate and up; 1: down)."""
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
        """The program's layers, its own pruning: the gate/up pair layer
        and the down layer."""
        (wg, wu, wd), (bg, bu, bd) = self.weights, self.biases
        return self._prune(wg, wu, wd, self.config["density"], self.block,
                           b_gate=bg, b_up=bu, b_down=bd)

    def engine(self):
        """The program's engine as the configuration states it: the
        hand-written kernels, fused, Connection Reordering on; the gate's
        activation is the hidden one."""
        from repro_torch import Engine

        final = self.config["final_activation"]
        return Engine(backend="kernel", activation=self.config["hidden_act"],
                      final_activation=None if final == "none" else final,
                      reorder=True,
                      reorder_iters=int(self.config["reorder_iters"]),
                      seed=int(self.config["reorder_seed"]), fuse=True,
                      device=self.device)

    def reference(self) -> reference_glu.SparseGLUFFN:
        wg, wu, wd = self.weights
        return reference_glu.SparseGLUFFN(
            wg, wu, wd, self.block, self.config["density"],
            self.config["hidden_act"], self.config["final_activation"],
            self.device, biases=self.biases)
