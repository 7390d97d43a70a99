"""What a loop is given (``Run``) and what it hands back (``Outcome``), and
the comparison with the reference that decides ``correct``."""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float                 # perf_counter() at the process's start
    control: Optional[str] = None    # "tf32": the reference in TF32 judged
    rate: Optional[float] = None     # an open loop's rate, for the sweep


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, float]
    memory_peak_bytes: int
    obs: Dict = dataclasses.field(default_factory=dict)
    info: Dict = dataclasses.field(default_factory=dict)


class Comparison:
    """The widest gap between the program's outputs and the reference's,
    over every row compared, as a share of the reference's RMS value over
    those rows (``max_err_rel``); a row that is not finite has an infinite
    gap."""

    def __init__(self):
        self.gaps: List[torch.Tensor] = []
        self.sumsq = 0.0
        self.count = 0

    def add(self, ys: torch.Tensor, refs: torch.Tensor) -> None:
        ys = ys.to(refs.device, torch.float32)
        if ys.shape != refs.shape:
            raise ValueError(f"outputs {tuple(ys.shape)} against reference "
                             f"{tuple(refs.shape)}")
        gap = (ys - refs).abs().amax(dim=1)
        gap = torch.where(torch.isfinite(gap), gap, math.inf)
        self.gaps.append(gap.double().cpu())
        self.sumsq += float(refs.double().pow(2).sum())
        self.count += refs.numel()

    @property
    def rows(self) -> int:
        return sum(len(g) for g in self.gaps)

    def _rel(self) -> torch.Tensor:
        rms = math.sqrt(self.sumsq / max(1, self.count))
        gaps = torch.cat(self.gaps) if self.gaps else torch.zeros(0)
        if rms > 0:
            return gaps / rms
        # an all-zero reference: only an exact answer is right
        return torch.where(gaps == 0, 0.0, math.inf)

    @property
    def max_err_rel(self) -> float:
        rel = self._rel()
        return float(rel.max()) if len(rel) else 0.0

    def wrong(self, limit: float) -> int:
        """Rows whose gap is above ``limit``."""
        return int((self._rel() > limit).sum())

    def wrong_adds(self, limit: float) -> int:
        """Calls of ``add`` with a row whose gap is above ``limit``."""
        rel = self._rel().split([len(g) for g in self.gaps])
        return sum(int(bool((g > limit).any())) for g in rel)


def settle() -> None:
    """The last step of set-up: collect what set-up left behind, so that
    no collection of it lands in the window."""
    gc.collect()


class GcPauses:
    """The interpreter's garbage collections while it is active: count and
    longest pause per generation (a pause stops every thread)."""

    def __init__(self):
        self.pauses: Dict[int, List[float]] = {0: [], 1: [], 2: []}
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(
                time.perf_counter() - self._t)

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> bool:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)
        return False

    def summary(self) -> Dict[str, List[float]]:
        """{generation: [collections, longest pause in ms]}"""
        return {str(g): [len(p), 1e3 * max(p, default=0.0)]
                for g, p in self.pauses.items()}


def free_device_memory() -> None:
    """Return what the freed program held to the device, so that the
    reference that runs next finds room."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))
