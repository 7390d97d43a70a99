"""Mean host time of one served batch before its forward runs, over the
profiled stretch: the program's spans ``batch.stack`` (the rows stacked),
``bucket.pad`` (conversion, cast and pad to the bucket), ``plan.input``
(the copy to the device) and ``plan.launch`` (scratch and launches),
summed, over the count of its ``batch.execute`` spans, from the program's
table of totals (``repro_torch.obs.trace.totals``), which only the
profiled stretch fills.  None where the program keeps no such table, or it
holds no batch."""

SPANS = ("batch.stack", "bucket.pad", "plan.input", "plan.launch")


def read(obs):
    try:
        from repro_torch.obs.trace import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    batches = spans.get("batch.execute", {}).get("count", 0)
    if not batches or not any(name in spans for name in SPANS):
        return None
    return 1e3 * sum(spans.get(name, {}).get("seconds", 0.0)
                     for name in SPANS) / batches
