"""Mean host time of one ``ExecutionPlan.__call__``, timed by the harness
around each call outside the profiled stretch: what the engine costs the
host per forward while the device runs behind it."""


def read(obs):
    spans = obs.get("host_call_s")
    if not spans:
        return None
    return 1e6 * sum(spans) / len(spans)
