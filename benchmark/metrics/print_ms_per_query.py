"""print_ms_per_query: host milliseconds in output/printer a query (the
records written to stdout), from the benchmark's spans around its entries."""

SPANS = {"print": ["krep_tpu_torch.output.printer:print_only_matching",
                   "krep_tpu_torch.output.printer:print_matching_lines",
                   "krep_tpu_torch.output.printer:print_count"]}


def read(run):
    if "print" not in run.spans:
        return None
    return run.spans["print"][0] * 1e3 / len(run.queries)
