"""window_gbps: query_gbps where the cell reads its rate per layer (count-the,
count-list64): bytes searched by every query in the window over the
window's seconds (host clock), in GB/s, taken in the traced run, so with
the profiler's cost in it. The reader is query_gbps.py's."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_query_gbps_base", Path(__file__).with_name("query_gbps.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
