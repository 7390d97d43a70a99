"""Deterministic, restart-safe data pipeline.

``SyntheticLM`` generates a reproducible Markov-chain token stream (so a ~100M
model has non-trivial structure to learn and the loss visibly decreases);
``TokenBatcher`` packs it into (tokens, labels) batches keyed by *step
number*, so a restarted job re-reads exactly the batches it would have seen —
the property the fault-tolerance path relies on.  ``sharded_batches`` moves
each batch to this rank's device, keeping this data rank's rows on a mesh
(the reference's places the batch onto a mesh with the dp sharding).

Port of ``repro.data.pipeline``: the classes are the reference's, line for
line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from ..launch import partition


@dataclasses.dataclass
class SyntheticLM:
    """Order-1 Markov chain over a small vocab with heavy-tailed transitions."""

    vocab: int
    seed: int = 0
    branching: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(
            0, self.vocab, size=(self.vocab, self.branching))
        probs = rng.dirichlet(np.ones(self.branching) * 0.5,
                              size=self.vocab)
        self.cum = np.cumsum(probs, axis=1)

    def sample(self, rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
        out = np.empty((batch, length + 1), dtype=np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, length + 1):
            u = rng.random(batch)
            choice = (u[:, None] > self.cum[cur]).sum(axis=1)
            cur = self.next_tokens[cur, np.minimum(choice, self.branching - 1)]
            out[:, t] = cur
        return out


class TokenBatcher:
    """step -> {"tokens", "labels"}; deterministic in (seed, step)."""

    def __init__(self, source: SyntheticLM, batch: int, seq_len: int,
                 seed: int = 0):
        self.source = source
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        seqs = self.source.sample(rng, self.batch, self.seq_len)
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def sharded_batches(batcher: TokenBatcher, device,
                    steps: Optional[int] = None, mesh=None) -> Iterator[Dict]:
    """Each step's batch as tensors on ``device``; on a (bound) mesh, only
    this data rank's rows, under the reference's batch specs (the rows are
    split over the data axes when they divide, else every rank keeps
    them all)."""
    step = 0
    while steps is None or step < steps:
        b = {k: torch.from_numpy(v) for k, v in batcher(step).items()}
        if mesh is not None and mesh.size > 1:
            specs = partition.batch_specs(mesh, b)
            b = {k: partition.local_shard(v, specs[k], mesh)
                 for k, v in b.items()}
        yield {k: v.to(device) for k, v in b.items()}
        step += 1
