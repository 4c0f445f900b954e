"""device_idle_pct: the share of the traced window in which no kernel, copy
or set ran on the card, from the profiler's trace."""


def read(run):
    if run.device is None or run.device["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
