"""device_idle_pct.count: device_idle_pct in the -c cells,
whose speed is the per-layer window_gbps; the reader is device_idle_pct.py's."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_device_idle_pct_base", Path(__file__).with_name("device_idle_pct.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
SPANS = getattr(_base, "SPANS", {})
read = _base.read
