"""The traced run's instruments: host spans around calls into the program,
and the device's timeline from torch.profiler.

Spans are the benchmark's own: `Spans.install` replaces a function of the
program (named "module:function") by a wrapper that adds the seconds of
each call, or of each step of a generator, to a named total, inside a
`torch.profiler.record_function` of that name, so the profiler's trace
holds them beside the device's operations on one clock.

`read_trace` takes the profiler's Chrome trace: the device operations
(kernels, copies, sets) inside the "window" annotation, their union (busy
time), and each idle gap named after the innermost host span that holds
its midpoint ("between_queries" where no query runs).
"""

from __future__ import annotations

import bisect
import functools
import importlib
import inspect
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME = 100  # characters of an operation's name that the breakdown keeps


class Spans:
    """Named host spans: total seconds and calls, from wrappers around the
    program's functions."""

    def __init__(self):
        self.totals = defaultdict(lambda: [0.0, 0])
        self._lock = threading.Lock()
        self._undo = []

    def _add(self, name: str, seconds: float, calls: int) -> None:
        with self._lock:
            t = self.totals[name]
            t[0] += seconds
            t[1] += calls

    def install(self, name: str, target: str) -> None:
        from torch.profiler import record_function

        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        add = self._add

        if inspect.isgeneratorfunction(orig):
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                it = orig(*args, **kwargs)
                while True:
                    t0 = time.perf_counter()
                    with record_function(name):
                        try:
                            item = next(it)
                        except StopIteration:
                            add(name, time.perf_counter() - t0, 1)
                            return
                    add(name, time.perf_counter() - t0, 0)
                    yield item
        else:
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    with record_function(name):
                        return orig(*args, **kwargs)
                finally:
                    add(name, time.perf_counter() - t0, 1)

        setattr(mod, attr, wrapper)
        self._undo.append((mod, attr, orig))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()


def profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_trace(prof) -> dict:
    """Device seconds inside the "window" annotation of a stopped profiler:
    kernel_s, h2d_s, d2h_s, busy_s, window_s, and the breakdown's
    device_ops and idle_gaps (seconds, the largest first)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans, device = [], []
    window = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") == "user_annotation":
            if e["name"] == "window":
                window = (a, b)
            else:
                spans.append((a, b, e["name"]))
        elif e.get("cat") in DEVICE_CATS:
            device.append((a, b, e["name"][:NAME], e["cat"]))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window annotation")
    w0, w1 = window
    clip = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device if b > w0 and a < w1]
    by_name = defaultdict(float)
    kernel = h2d = d2h = 0.0
    for a, b, n, c in clip:
        by_name[n] += (b - a) * 1e-6
        if c == "kernel":
            kernel += b - a
        elif "HtoD" in n:
            h2d += b - a
        elif "DtoH" in n:
            d2h += b - a
    busy = _union([(a, b) for a, b, _, _ in clip])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    spans.sort()
    starts = [s[0] for s in spans]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        for s0, s1, name in reversed(spans[max(0, i - 4096) : i]):
            if s1 >= mid and (best is None or s1 - s0 < best[1] - best[0]):
                best = (s0, s1, name)
        idle[best[2] if best else "between_queries"] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "kernel_s": kernel * 1e-6, "h2d_s": h2d * 1e-6, "d2h_s": d2h * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
        "device_ops": top(by_name), "idle_gaps": top(idle),
    }
