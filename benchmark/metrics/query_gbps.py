"""query_gbps: bytes of the searched file of every query in the window
over the window's seconds (host clock), in GB/s. The window holds whole
queries only."""


def read(run):
    if run.target_bytes is None:
        return None
    return run.target_bytes * len(run.queries) / run.window_s / 1e9
