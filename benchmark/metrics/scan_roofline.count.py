"""scan_roofline.count: scan_roofline in the -c cells,
whose speed is the per-layer window_gbps; the reader is scan_roofline.py's."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_scan_roofline_base", Path(__file__).with_name("scan_roofline.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
SPANS = getattr(_base, "SPANS", {})
read = _base.read
