"""stage_ms_per_query: host milliseconds in ops/dispatch.stage a query
(page cache to the pinned buffer, and the start of the copy to the card),
from the benchmark's span around it."""

SPANS = {"stage": ["krep_tpu_torch.ops.dispatch:stage"]}


def read(run):
    if "stage" not in run.spans:
        return None
    return run.spans["stage"][0] * 1e3 / len(run.queries)
