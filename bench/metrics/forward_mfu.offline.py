"""The whole forward's share of the chip's f32 peak: the sparse FLOPs of
the traced run's calls outside its profiled stretch, over (the time outside
the stretch x peak).  Synchronisations bound the stretch, so this is the
untraced rate's share of the peak, read in the traced run.  Where the
forward is compute-bound it reads no more than ``forward_roofline.offline``,
which leaves out the device's idle time."""


def read(obs):
    peak = obs.get("peaks")
    counts, inside = obs.get("calls_by_batch"), obs.get("stretch_calls_by_batch")
    seconds = obs.get("unprofiled_s")
    if not peak or not counts or not inside or not seconds:
        return None
    flops = sum(w["flops"] * (c - k) for w, c, k in
                zip(obs["work_by_batch"], counts, inside))
    if flops <= 0:
        return None
    return 100.0 * flops / (seconds * peak["f32_flops"])
