"""The port's tracing (krep_tpu_torch/utils/profiling.py) on the CPU: the
off path, the spans of a device-route query and their nesting, the
profiler's annotations, the printer's counters, the per-query
KREP_TPU_PROFILE line, and the benchmark's readers of the registry."""

import contextlib
import importlib.util
import io
import json
import re
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import naive
from krep_tpu_torch import cli
from krep_tpu_torch.ops import dispatch
from krep_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
METRICS = REPO / "benchmark" / "metrics"
READERS = ("stage_pin_ms_per_query", "stage_copy_ms_per_query", "device_wait_ms_per_query",
           "readback_expand_ms_per_query", "print_write_ms_per_query", "unspanned_ms_per_query")
STAGE = ("stage.pin", "stage.copy", "stage.h2d", "device.wait")


@pytest.fixture
def registry(monkeypatch):
    """An empty registry, tracing off, the device route on the CPU."""
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    monkeypatch.setenv("KREP_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("KREP_TPU_PROFILE", raising=False)
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("prof") / "t.txt"
    p.write_bytes(naive.gen_english(5, 3 << 20))
    return p


def query(argv, out=None):
    """cli.main on the CPU: (rc, stdout, stderr)."""
    out = io.BytesIO() if out is None else out
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(list(argv), out=out, device="cpu")
    return rc, out.getvalue() if isinstance(out, io.BytesIO) else None, err.getvalue()


def test_off_records_nothing_and_enters_no_record_function(registry, corpus, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for argv in (["-c", "the"], ["-o", "the"]):
        rc, out, err = query([*argv, str(corpus)])
        assert rc == 0 and out and err == ""
    assert registry.records() == [] and registry.totals() == {}
    assert registry.span("stage.copy").__enter__() is None
    # the counters that cost one add stay on
    assert registry.counter("route.single") == 2
    assert registry.counter("stage.bytes") == 2 * dispatch.bucket_size(corpus.stat().st_size)
    assert not any(k.startswith("print.") for k in registry.counters())


def test_device_route_spans_nest_under_one_root(registry, corpus):
    registry.enable()
    rc, out, _ = query(["-c", "the", str(corpus)])
    assert rc == 0
    recs = registry.records()
    (root,) = [r for r in recs if r.name == "query"]
    assert root.parent is None and root.query is not None
    by_name = {r.name: r for r in recs}
    for name in STAGE:
        r = by_name[name]
        assert r.parent is root and r.query == root.query
        assert root.start <= r.start <= r.end <= root.end
    assert by_name["stage.pin"].end <= by_name["stage.copy"].start
    assert by_name["stage.copy"].end <= by_name["stage.h2d"].start
    assert registry.counter("stage.bytes") == dispatch.bucket_size(corpus.stat().st_size)
    assert registry.counter("d2h.bytes") == 8  # the totals' count and lines, int32
    tot = registry.totals()
    secs, calls, own = tot["query"]
    assert calls == 1 and 0 <= own <= secs
    children = sum(tot[n][0] for n in tot if n != "query")
    assert own == pytest.approx(secs - children, abs=1e-6)


def test_pipelined_staging_spans_and_counters(registry, corpus, monkeypatch):
    """The staging pipeline (a chunk of four blocks, so the 3 MiB corpus
    takes it): one `stage.copy` span over the whole fill loop, each chunk's
    copy issued in a `stage.h2d` span inside it, the bytes of the whole
    bucket, and the pipeline's counters in the KREP_TPU_PROFILE line. The
    CPU has no copy to issue, so a separate CPU buffer stands in for the
    card's."""
    want = query(["-c", "the", str(corpus)])  # the single copy
    registry.reset()
    monkeypatch.setattr(dispatch, "CHUNK_BYTES", 4 * 65536)
    monkeypatch.setattr(dispatch, "_device_buffer", lambda host, dev: torch.empty_like(host))
    monkeypatch.setenv("KREP_TPU_PROFILE", "1")
    size = dispatch.bucket_size(corpus.stat().st_size)
    chunks = size // (4 * 65536)
    rc, out, err = query(["-c", "the", str(corpus)])
    assert (rc, out) == want[:2] and rc == 0
    recs = registry.records()
    (root,) = [r for r in recs if r.name == "query"]
    (copy,) = [r for r in recs if r.name == "stage.copy"]
    h2d = [r for r in recs if r.name == "stage.h2d"]
    assert copy.parent is root and len(h2d) == chunks
    assert all(r.parent is copy and copy.start <= r.start <= r.end <= copy.end for r in h2d)
    assert registry.totals()["stage.copy"][1] == 1
    for name, n in (("stage.bytes", size), ("h2d.bytes", size), ("stage.pipelined", 1),
                    ("stage.chunks", chunks)):
        assert registry.counter(name) == n
    line = err.splitlines()[-1]
    assert re.search(r"stage\.copy [0-9.]+ \(1\)", line)
    assert re.search(rf"stage\.h2d [0-9.]+ \({chunks}\)", line)
    assert "stage.pipelined 1" in line and f"stage.chunks {chunks}" in line


def test_profiler_trace_holds_the_spans_inside_the_root(registry, corpus, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rc, _, err = query(["-c", "the", str(corpus)])
    assert rc == 0 and err == ""  # the profiler alone writes nothing to stderr
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    root = ann["krep.query"]
    for name in STAGE:
        e = ann["krep." + name]
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
    assert registry.totals()["stage.copy"][1] == 1


def test_printer_counts_bytes_records_and_write_time(registry, corpus, tmp_path):
    registry.enable()
    path = tmp_path / "out.txt"
    with open(path, "wb") as f:  # through an fd: the native -o pass
        rc, _, _ = query(["-o", "the", str(corpus)], out=f)
    data = path.read_bytes()
    assert rc == 0 and data.count(b"\n") > 4096
    assert registry.counter("print.bytes") == len(data)
    assert registry.counter("print.records") == data.count(b"\n")
    assert registry.counter("print.write_ns") > 0
    assert registry.totals()["print"][1] == 1
    # the Python paths: the default line mode into a buffer
    registry.reset()
    rc, out, _ = query(["the", str(corpus)])
    assert registry.counter("print.bytes") == len(out)
    assert registry.counter("print.records") == out.count(b"\n")
    assert registry.counter("print.write_ns") > 0


def test_profile_env_is_read_per_query(registry, corpus, monkeypatch):
    monkeypatch.setenv("KREP_TPU_PROFILE", "1")
    _, _, err = query(["-o", "the", str(corpus)])
    lines = err.splitlines()
    assert len(lines) == 1
    m = re.fullmatch(r"krep-tpu: query (\d+): route single; self ms: (.*); counters: (.*)",
                     lines[0])
    assert m
    spans = dict(re.findall(r"([a-z0-9._]+) [0-9.]+ \((\d+)\)", m.group(2)))
    assert {"query", "stage.copy", "device.wait", "readback.expand", "positions",
            "print"} <= set(spans)
    counters = dict(re.findall(r"([a-z0-9._]+) (\d+)", m.group(3)))
    assert counters["route.single"] == "1" and int(counters["print.records"]) > 0
    _, _, err2 = query(["-c", "the", str(corpus)])
    (line2,) = err2.splitlines()
    assert int(re.match(r"krep-tpu: query (\d+)", line2).group(1)) == int(m.group(1)) + 1
    monkeypatch.delenv("KREP_TPU_PROFILE")
    assert query(["-c", "the", str(corpus)])[2] == ""
    assert registry.totals()["query"][1] == 2


def test_host_route_keeps_its_scan_line(registry, corpus, monkeypatch):
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", str(1 << 30))
    monkeypatch.setenv("KREP_TPU_PROFILE", "1")
    _, _, err = query(["-c", "the", str(corpus)])
    lines = err.splitlines()
    assert lines[0].startswith("krep-tpu: host route: ")
    assert re.fullmatch(r"krep-tpu: scan\[host\] m=3: \d+ bytes in [0-9.]+ ms "
                        r"\([0-9.]+ GB/s wall\)", lines[1])
    assert lines[2].startswith("krep-tpu: query ") and "route host;" in lines[2]
    assert "scan.host" in lines[2] and len(lines) == 3


def test_threads_and_self_time(registry):
    registry.enable()
    seen = {}
    with registry.span("outer") as outer:
        def work():
            with registry.span("alone") as a:
                seen["alone"] = a
            with registry.span("child", parent=outer) as c:
                seen["child"] = c

        t = threading.Thread(target=work)
        t.start()
        t.join()
        with registry.span("inner") as inner:
            pass
    assert seen["alone"].parent is None and seen["child"].parent is outer
    assert inner.parent is outer
    secs, calls, own = registry.totals()["outer"]
    # only the same-thread child is taken from the outer span's self time
    assert own == pytest.approx(secs - registry.totals()["inner"][0], abs=1e-6)


def test_ring_keeps_the_newest(registry, monkeypatch):
    monkeypatch.setattr(profiling, "_RING", profiling.deque(maxlen=4))
    registry.enable()
    for i in range(10):
        with registry.span(f"s{i}"):
            pass
    assert [r.name for r in registry.records()] == ["s6", "s7", "s8", "s9"]
    assert registry.totals()["s0"][1] == 1


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_readers_read_the_registry(registry, monkeypatch):
    registry.enable()
    ms = 1_000_000
    clock = iter(range(0, 10**12, ms))  # each reading 1 ms after the last
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=lambda: next(clock)))
    # two hand-built queries: each 1 ms of pin, 1 of copy, 1 of wait and 1
    # of expand inside a root of 9 ms (so 5 ms of its own)
    for _ in range(2):
        with profiling.query():
            for name in ("stage.pin", "stage.copy", "device.wait", "readback.expand"):
                with registry.span(name):
                    pass
            registry.count("print.write_ns", 3 * ms)
    run = SimpleNamespace(queries=[object(), object()])
    want = {"stage_pin_ms_per_query": 1.0, "stage_copy_ms_per_query": 1.0,
            "device_wait_ms_per_query": 1.0, "readback_expand_ms_per_query": 1.0,
            "print_write_ms_per_query": 3.0, "unspanned_ms_per_query": 5.0}
    for name in READERS:
        assert _reader(name).read(run) == pytest.approx(want[name]), name
    # without the program, or with one whose registry is empty
    monkeypatch.delitem(sys.modules, "krep_tpu_torch.utils.profiling")
    assert all(_reader(n).read(run) is None for n in READERS)
    monkeypatch.setitem(sys.modules, "krep_tpu_torch.utils.profiling", registry)
    registry.reset()
    assert all(_reader(n).read(run) is None for n in READERS)


def test_benchmark_trace_run_reports_the_new_metrics(tmp_path):
    """The o-the cell at 1 MiB on the CPU, traced, with the host route off:
    the six readers find their spans, and staging's split sums to the
    benchmark's own span of it."""
    sys.path.insert(0, str(REPO / "benchmark" / "tests"))
    try:
        from bench_helpers import SMALL, checkout, run
    finally:
        sys.path.pop(0)
    root = checkout(tmp_path, config_params=SMALL)
    prelude = ("import krep_tpu_torch.ops.hostscan as h; h.threshold = lambda: 0")
    proc = run(root, "subtitles_en.o-the", seed=2**31 + 5, trace=1, prelude=prelude)
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, proc.stderr[-2000:]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(READERS) <= set(got), got
    split = got["stage_pin_ms_per_query"] + got["stage_copy_ms_per_query"]
    assert 0 < split <= got["stage_ms_per_query"]
    assert got["readback_expand_ms_per_query"] <= got["readback_ms_per_query"]
    assert got["print_write_ms_per_query"] <= got["print_ms_per_query"]
    assert all(v >= 0 for v in got.values())
