"""h2d_ms_per_query: device milliseconds of host-to-device copies a query,
from the profiler's trace of the window."""


def read(run):
    if run.device is None or run.device["h2d_s"] <= 0:
        return None
    return run.device["h2d_s"] * 1e3 / len(run.queries)
