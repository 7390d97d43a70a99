"""Share of a profiled stretch of the window in which no operation ran on
the device: 1 - (union of all device activity intervals / stretch)."""


def read(obs):
    s = obs.get("stretch")
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
