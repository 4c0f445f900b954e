"""query_p95_ms: the 95th percentile of every window query's time, on the
host clock (layer: cli, the whole query)."""

import statistics


def read(run):
    times = [q.seconds * 1e3 for q in run.queries]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[-1]
