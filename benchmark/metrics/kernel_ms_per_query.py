"""kernel_ms_per_query: device milliseconds of all kernels a query, from
the profiler's trace of the window."""


def read(run):
    if run.device is None or run.device["kernel_s"] <= 0:
        return None
    return run.device["kernel_s"] * 1e3 / len(run.queries)
