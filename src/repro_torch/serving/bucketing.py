"""Bucketed execution plans: variable batch sizes over one compiled schedule.

Port of ``repro.serving.bucketing`` (the plan store and sharded plans are not
ported yet).  The offline cost — block DAG, Theorem-1 order, Connection
Reordering, schedule packing — is paid once by a single ``Engine.compile``;
each power-of-two batch bucket gets its own forward over the *same* schedule
tensors, a batch of n rows runs through the smallest bucket >= n, and is
padded only up to that bucket.  The kernels' work grows with the padded
batch, so small buckets keep tail batches cheap.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.blocksparse import BlockFFNN, BSRLayer
from ..engine import Engine, ExecutionPlan
from ..obs.trace import NULL_TRACER


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself when it
    is not a power of two."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class BucketedPlanSet:
    """One compiled schedule, one forward per batch bucket."""

    base: ExecutionPlan
    buckets: Tuple[int, ...]
    plans: Dict[int, ExecutionPlan]
    bucket_calls: Dict[int, int] = dataclasses.field(default_factory=dict)
    warmup_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    compile_s: float = 0.0            # wall time of the compile
    safe_mode: bool = False           # True on a safe twin (torch backend)
    tracer: Optional[object] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    @property
    def _tr(self):
        tr = self.tracer
        return tr if tr is not None else NULL_TRACER

    @classmethod
    def compile(
        cls,
        net: Union[BlockFFNN, Sequence[BSRLayer]],
        engine: Optional[Engine] = None,
        max_batch: int = 32,
        backend: Optional[str] = None,
    ) -> "BucketedPlanSet":
        """Compile the schedule once, then fan it out across batch buckets."""
        engine = engine or Engine()
        tracer = engine.tracer
        tr = tracer if tracer is not None else NULL_TRACER
        t0 = time.perf_counter()
        base = engine.compile(net, backend)
        sizes = bucket_sizes(max_batch)
        with tr.span("bucket.fanout", buckets=len(sizes)):
            plans = {b: base.with_fresh_forward() for b in sizes}
        return cls(base=base, buckets=sizes, plans=plans,
                   bucket_calls={b: 0 for b in sizes},
                   compile_s=time.perf_counter() - t0, tracer=tracer)

    def build_safe_twin(self) -> "BucketedPlanSet":
        """This set's schedule fanned out through the ``torch`` backend:
        same buckets, same schedule tensors by reference."""
        safe_base = self.base.safe_twin()
        return dataclasses.replace(
            self,
            base=safe_base,
            plans={b: safe_base.with_fresh_forward() for b in self.buckets},
            bucket_calls={b: 0 for b in self.buckets},
            warmup_s={},
            safe_mode=True,
        )

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @property
    def n_in(self) -> int:
        return self.base.n_in

    @property
    def n_out(self) -> int:
        return self.base.n_out

    @property
    def dtype(self) -> torch.dtype:
        """The input dtype every bucket runs with; inputs are cast to it."""
        return self.base.dtype

    @property
    def weight_dtype(self) -> str:
        return self.base.weight_dtype

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` rows (the largest one if none)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def warmup(self) -> "BucketedPlanSet":
        """Run every bucket once ahead of traffic (the first call builds the
        kernels), then time one more call per bucket into ``warmup_s`` — the
        seed of the server's per-bucket latency estimate.  Warmup calls are
        not counted in ``bucket_calls`` or the plans' ``calls``."""
        tr = self._tr
        device = self.base.device
        for b in self.buckets:
            with tr.span("bucket.warmup", bucket=b,
                         safe_mode=self.safe_mode) as sp:
                x = torch.zeros((b, self.n_in), dtype=self.dtype,
                                device=device)
                self.plans[b](x)
                _sync(device)
                t0 = time.perf_counter()
                self.plans[b](x)
                _sync(device)
                self.warmup_s[b] = time.perf_counter() - t0
                sp["warmup_s"] = round(self.warmup_s[b], 6)
            self.plans[b].calls = 0
        return self

    def __call__(self, x) -> np.ndarray:
        """Run a batch of any size.  ``x`` is ``[n, n_in]``; batches larger
        than the top bucket run in top-bucket chunks.  Returns host numpy."""
        x = torch.as_tensor(x).to(self.dtype)
        if x.ndim != 2 or x.shape[1] != self.n_in:
            raise ValueError(
                f"expected input [n, {self.n_in}], got {tuple(x.shape)}")
        n = x.shape[0]
        if n > self.max_batch:
            parts = [self(x[i:i + self.max_batch])
                     for i in range(0, n, self.max_batch)]
            return np.concatenate(parts)
        b = self.bucket_for(n)
        if n < b:
            x = torch.cat([x, x.new_zeros((b - n, x.shape[1]))])
        self.bucket_calls[b] += 1
        y = self.plans[b](x)
        return y[:n].cpu().numpy()

    def describe(self) -> str:
        extra = " [SAFE MODE]" if self.safe_mode else ""
        return (f"BucketedPlanSet buckets={list(self.buckets)}{extra}; "
                + self.base.describe())
