"""Mean time one served batch's answers take to come back to the host,
over the profiled stretch: the program's span ``bucket.fetch`` (the copy
back and the wait for the device) over the count of its ``batch.execute``
spans, from the program's table of totals
(``repro_torch.obs.trace.totals``), which only the profiled stretch fills.
None where the program keeps no such table, or it holds no batch."""


def read(obs):
    try:
        from repro_torch.obs.trace import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    batches = spans.get("batch.execute", {}).get("count", 0)
    fetch = spans.get("bucket.fetch")
    if not batches or fetch is None:
        return None
    return 1e3 * fetch["seconds"] / batches
