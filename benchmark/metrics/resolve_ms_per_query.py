"""resolve_ms_per_query: host milliseconds in engine/resolve.apply_policy a
query (the -o match policy over the starts), from the benchmark's span
around it."""

SPANS = {"resolve": ["krep_tpu_torch.engine.resolve:apply_policy"]}


def read(run):
    if "resolve" not in run.spans:
        return None
    return run.spans["resolve"][0] * 1e3 / len(run.queries)
