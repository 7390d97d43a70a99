"""The forward's share of its roofline: the least time the chip could take
for the calls of a profiled stretch (per call the larger of FLOPs over the
f32 peak and bytes over HBM bandwidth, from ``sparsebench.work``), over the
device time they took (the union of all device activity in the stretch,
whatever the kernels are named)."""

from sparsebench import work


def read(obs):
    s, peak = obs.get("stretch"), obs.get("peaks")
    counts = obs.get("stretch_calls_by_batch")
    if not s or not peak or not counts or not sum(counts) or s["busy_s"] <= 0:
        return None
    bound = sum(work.bound_s(w, peak) * c
                for w, c in zip(obs["work_by_batch"], counts))
    return 100.0 * bound / s["busy_s"]
