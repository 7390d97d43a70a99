"""A profiled stretch of the window, reduced to what the metrics read.

``Stretch`` runs ``torch.profiler`` (host and device activity) between two
synchronisations, so every device activity it records belongs to work
issued inside it.  ``summarize`` reduces the trace: the union of all device
activity intervals (busy time; overlapping activities count once), the
device operations that took most time, and the idle gaps by what the host
was doing in them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MARK = "sparsebench.stretch"
#: gaps attributed one by one to a host operation; the rest are summed
ATTRIBUTED_GAPS = 500
TOP = 10


class Stretch:
    """``with Stretch(device) as s: ...``; then, once the window has
    closed, ``s.summary()`` (None where the device is not a CUDA device or
    the trace shows no device work).  Reading the trace takes the host some
    seconds, so it waits until nothing is measured."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._prof = None

    @staticmethod
    def prepare(device) -> None:
        """Start the profiler once during set-up: its first start loads
        and initialises the device tracer, a stall the window should not
        see."""
        with Stretch(device) as s:
            pass
        s._prof = None

    def __enter__(self) -> "Stretch":
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        return False

    def summary(self) -> Optional[Dict]:
        if self._prof is None:
            return None
        out = summarize(self._prof.events())
        self._prof = None
        return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge intervals [[start, end], ...] (sorted by start) into disjoint
    ones."""
    merged: List[List[float]] = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.float64).reshape(-1, 2)


def summarize(events) -> Optional[Dict]:
    """``busy_s``, ``window_s`` (the marked stretch on the trace's clock),
    ``device_ops`` and ``idle_gaps`` ([[name, seconds], ...], at most 10
    each).  None when the trace holds no device activity."""
    from torch.autograd import DeviceType

    mark = [e for e in events if e.name == MARK
            and e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != MARK]
    if not mark or not dev:
        return None
    m0 = mark[0].time_range.start
    m1 = mark[0].time_range.end
    iv = np.array(sorted((e.time_range.start, e.time_range.end)
                         for e in dev), dtype=np.float64)
    iv = np.clip(iv, m0, m1)
    busy = _union(iv)
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())

    by_op: Dict[str, float] = {}
    for e in dev:
        key = e.name[:96]
        by_op[key] = by_op.get(key, 0.0) + e.time_range.elapsed_us()

    edges = np.concatenate([[m0], busy.ravel(), [m1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name != MARK]
    idle = _attribute(gaps, host)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (m1 - m0) / 1e6,
        "device_ops": _top(by_op),
        "idle_gaps": _top(idle),
    }


def _attribute(gaps: np.ndarray, host) -> Dict[str, float]:
    """Idle microseconds by the host operation that overlaps each gap most
    (the shortest such operation on a tie); the longest
    ``ATTRIBUTED_GAPS`` gaps one by one, the others together."""
    out: Dict[str, float] = {}
    if not len(gaps):
        return out
    lens = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-lens)
    hs = np.array([e.time_range.start for e in host], dtype=np.float64)
    he = np.array([e.time_range.end for e in host], dtype=np.float64)
    names = [e.name[:96] for e in host]
    for i in order[:ATTRIBUTED_GAPS]:
        g0, g1 = gaps[i]
        over = np.minimum(he, g1) - np.maximum(hs, g0)
        name = "(no host operation)"
        if len(over) and over.max() > 0:
            best = over.max()
            cand = np.flatnonzero(over >= best)
            j = cand[np.argmin(he[cand] - hs[cand])]
            name = names[j]
        out[name] = out.get(name, 0.0) + float(lens[i])
    rest = float(lens[order[ATTRIBUTED_GAPS:]].sum())
    if rest > 0:
        out["(shorter gaps, not attributed)"] = rest
    return out


def _top(us_by_name: Dict[str, float]) -> List[Tuple[str, float]]:
    items = sorted(us_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, us / 1e6] for name, us in items]
