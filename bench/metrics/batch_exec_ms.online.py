"""Mean time the program takes to execute one formed batch: the bucketed
plan's call with its host copies, as ``SparseServer._run_batch`` times it
into ``ServingMetrics.exec_s`` (the interval of its ``batch.execute``
span), over the window's batches up to the profiled stretch."""


def read(obs):
    total_count = obs.get("batch_exec_s")
    if not total_count or not total_count[1]:
        return None
    total, count = total_count
    return 1e3 * total / count
