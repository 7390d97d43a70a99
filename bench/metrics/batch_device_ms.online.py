"""Mean device time of the kernels of one served batch over the profiled
stretch: the stretch's device operations that are kernels (not memory
copies or sets, and not the program's own spans, which the profiler shows
on the device too where they enclose a launch), summed, over the count of
the program's ``batch.execute`` spans in its table of totals
(``repro_torch.obs.trace.totals``), which only the profiled stretch fills.
None where the run has no device trace (a CPU run), or the program keeps
no such table, or it holds no batch."""

COPIES = ("Memcpy", "Memset")


def read(obs):
    stretch = obs.get("stretch")
    if not stretch:
        return None
    try:
        from repro_torch.obs.trace import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    batches = spans.get("batch.execute", {}).get("count", 0)
    if not batches:
        return None
    kernels = sum(seconds for name, seconds in stretch["device_ops"]
                  if not name.startswith(COPIES) and name not in spans)
    return 1e3 * kernels / batches
