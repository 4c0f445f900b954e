"""stage_pin_ms_per_query.count: stage_pin_ms_per_query in the -c cells,
whose speed is the per-layer window_gbps; the reader is stage_pin_ms_per_query.py's."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_stage_pin_ms_per_query_base", Path(__file__).with_name("stage_pin_ms_per_query.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
SPANS = getattr(_base, "SPANS", {})
read = _base.read
