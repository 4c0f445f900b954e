"""readback_ms_per_query: host milliseconds in
ops/dispatch.starts_from_device_mask a query (the mask's match starts
copied back from the card), from the benchmark's span around it."""

SPANS = {"readback": ["krep_tpu_torch.ops.dispatch:starts_from_device_mask"]}


def read(run):
    if "readback" not in run.spans:
        return None
    return run.spans["readback"][0] * 1e3 / len(run.queries)
