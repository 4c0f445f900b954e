"""scan_roofline: the least time the card could take for a query's own
work over the time its kernels took, in %. The work: the searched file's
bytes read once, and for -o 4 bytes written once for each printed match
(a match's start offset), at the card's HBM bandwidth (peaks.json),
whatever kernels do it."""


def read(run):
    if run.device is None or run.device["kernel_s"] <= 0 or run.peak is None:
        return None
    if run.target_bytes is None:
        return None
    matches = sum(q.lines for q in run.queries) if "-o" in run.argv else 0
    work = run.target_bytes * len(run.queries) + 4 * matches
    return 100.0 * work / run.peak["hbm_bytes_per_s"] / run.device["kernel_s"]
