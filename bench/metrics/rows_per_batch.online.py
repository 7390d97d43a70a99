"""Mean rows per batch the program's scheduler formed, over the window's
batches up to the profiled stretch (``ServingMetrics.batch_sizes``, reset at
the window's start, so the warm-up's batches are not in it)."""


def read(obs):
    total_count = obs.get("batch_rows")
    if not total_count or not total_count[1]:
        return None
    total, count = total_count
    return float(total) / count
