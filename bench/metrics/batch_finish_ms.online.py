"""Mean time the scheduler spends completing one served batch after its
answers are on the host, over the profiled stretch: the program's span
``batch.finish`` (latency estimate, result slots and their waiters woken,
eviction, the batch's metrics, under the server's lock) over the count of
its ``batch.execute`` spans, from the program's table of totals
(``repro_torch.obs.trace.totals``), which only the profiled stretch fills.
None where the program keeps no such table, or it holds no batch."""


def read(obs):
    try:
        from repro_torch.obs.trace import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    batches = spans.get("batch.execute", {}).get("count", 0)
    finish = spans.get("batch.finish")
    if not batches or finish is None:
        return None
    return 1e3 * finish["seconds"] / batches
