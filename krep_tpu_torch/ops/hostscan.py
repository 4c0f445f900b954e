"""Host fast path for the small-input regime + its break-even routing.

The host half of krep_tpu/ops/hostscan.py, copied. Below a break-even byte
count a native host scan answers a literal search with no staging transfer
and no launch: sub-break-even texts and `-r` batches go to
`native/runtime.c::krep_literal_scan` (u64-SWAR candidate detect + verify,
ALL-advance), the device takes everything larger. The reference's
small-file cost is one open+read+scan with no launch overhead
(krep.c:3402-3430 feeding the kernel selection at krep.c:1771-1870).

Semantics: the native scan returns ALL-overlap match starts (or in-stream
counts); advance policies, -m truncation, and position assembly reuse the
SAME resolution stage the device mask path uses (engine/resolve.py), so
parity corners are enforced in exactly one place.

Break-even: KREP_TPU_HOST_BREAKEVEN overrides (bytes; 0 disables the host
route); else this package's own disk-cached `calibrate()` record
($KREP_TPU_CACHE_DIR/breakeven-torch.json); else a 32 MiB default.
`calibrate()` times the native host scan and the staged device scan and
solves for the crossover. The JAX package caches its record as
breakeven.json in the same directory; that record measures another device
and is never read here. KREP_TPU_PROFILE=1 logs each routing decision.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

DEFAULT_BREAKEVEN = 32 << 20
BREAKEVEN_CAP = 1 << 30  # never route texts beyond the single-slab size

_native = None
_native_tried = False


def _nat():
    global _native, _native_tried
    if not _native_tried:
        _native_tried = True
        try:
            from ..native import runtime as _rt

            _native = _rt
        except Exception:
            _native = None
    return _native


def available() -> bool:
    return _nat() is not None


def _cache_path() -> str:
    cache = os.environ.get(
        "KREP_TPU_CACHE_DIR", os.path.expanduser("~/.cache/krep_tpu")
    )
    return os.path.join(cache, "breakeven-torch.json")


_threshold_cache: int | None = None


def threshold() -> int:
    """Routing threshold in bytes (inputs at or below it scan host-side)."""
    global _threshold_cache
    env = os.environ.get("KREP_TPU_HOST_BREAKEVEN")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            return DEFAULT_BREAKEVEN
    if _threshold_cache is None:
        val = DEFAULT_BREAKEVEN
        try:
            with open(_cache_path()) as f:
                rec = json.load(f)
            val = int(rec["breakeven_bytes"])
        except Exception:
            pass
        _threshold_cache = min(max(val, 0), BREAKEVEN_CAP)
    return _threshold_cache


def route_small(n_bytes: int, k_patterns: int = 1) -> bool:
    """True when an n-byte (xK patterns) literal scan should run host-side.
    The host cost is ~K passes, so multi-pattern inputs compare K*n against
    the single-pattern break-even."""
    if n_bytes <= 0:
        return False
    t = threshold()
    if t <= 0 or not available():
        return False
    hit = n_bytes * max(1, k_patterns) <= t
    if hit and os.environ.get("KREP_TPU_PROFILE") == "1":
        sys.stderr.write(
            f"krep-tpu: host route: {n_bytes} bytes x {k_patterns} patterns "
            f"<= break-even {t}\n"
        )
    return hit


def _as_u8(text) -> np.ndarray:
    if isinstance(text, (bytes, bytearray, memoryview)):
        return np.frombuffer(text, np.uint8)
    return np.asarray(text, dtype=np.uint8)


def scan_starts(
    data, pattern: bytes, case_sensitive: bool, whole_word: bool
) -> np.ndarray:
    """ALL-overlap match starts (sorted int64) — host twin of the device
    mask + starts_from_device_mask pipeline."""
    _, starts = _nat().literal_scan(
        _as_u8(data), pattern, not case_sensitive, whole_word,
        count_lines=False, track_positions=True,
    )
    return starts


def scan_count(
    data, pattern: bytes, case_sensitive: bool, whole_word: bool,
    count_lines: bool, max_count: int | None = None,
) -> int:
    cnt, _ = _nat().literal_scan(
        _as_u8(data), pattern, not case_sensitive, whole_word,
        count_lines=count_lines, track_positions=False, max_count=max_count,
    )
    return cnt


def batch_counts(
    buf, bounds: np.ndarray, pattern: bytes, case_sensitive: bool,
    whole_word: bool, count_lines: bool,
) -> np.ndarray:
    """Per-file counts over a concatenated batch buffer, one native call."""
    return _nat().batch_literal_counts(
        _as_u8(buf), bounds, pattern, not case_sensitive, whole_word,
        count_lines,
    )


def search_single_host(params, text, policy):
    """Full single-literal search on the host (sub-break-even inputs).
    Mirrors the staged-path resolution tail in engine/search.py exactly:
    ALL starts -> apply_policy -> truncate -> positions."""
    from ..engine import resolve
    from ..engine.search import SearchResult, _EMPTY_POS
    from ..params import MatchPolicy
    from ..utils import profiling

    data = _as_u8(text)
    n = data.shape[0]
    m = len(params.pattern)
    max_count = params.max_count

    with profiling.scan_span(f"scan[host] m={m}", n):
        if params.count_lines_mode:
            lines = scan_count(
                data, params.pattern, params.case_sensitive,
                params.whole_word, count_lines=True, max_count=max_count,
            )
            count = min(lines, max_count) if max_count is not None else lines
            return SearchResult(count, _EMPTY_POS, n)

        need_positions = params.track_positions and not params.count_matches_mode
        if policy is MatchPolicy.ALL and not need_positions:
            c = scan_count(
                data, params.pattern, params.case_sensitive,
                params.whole_word, count_lines=False, max_count=max_count,
            )
            count = min(c, max_count) if max_count is not None else c
            return SearchResult(count, _EMPTY_POS, n)

        starts = scan_starts(
            data, params.pattern, params.case_sensitive, params.whole_word
        )
        starts = resolve.apply_policy(starts, m, policy, n)
        starts = resolve.truncate_max_count(starts, max_count)
        if params.count_matches_mode or not params.track_positions:
            return SearchResult(len(starts), _EMPTY_POS, n)
        positions = np.stack([starts, starts + m], axis=1).astype(np.int64)
        return SearchResult(len(starts), positions, n)


def search_multi_host(params, text, patterns):
    """K-pattern host search: per-pattern native all-starts passes merged
    with the same AC-order resolution the device union-mask path uses
    (AC total == sum of per-pattern ALL counts,
    test_multiple_patterns.c:345-471)."""
    from ..engine import resolve
    from ..engine.search import SearchResult, _EMPTY_POS
    from ..utils import profiling

    data = _as_u8(text)
    n = data.shape[0]
    mc = params.max_count

    with profiling.scan_span(f"scan[host] K={len(patterns)}", n):
        need_positions = params.track_positions and not params.count_matches_mode

        if not need_positions and not params.count_lines_mode:
            total = 0
            for p in patterns:
                total += scan_count(
                    data, p, params.case_sensitive, params.whole_word,
                    count_lines=False,
                )
                if mc is not None and total >= mc:
                    break
            return SearchResult(
                min(total, mc) if mc is not None else total, _EMPTY_POS, n
            )

        starts_list, ends_list = [], []
        for p in patterns:
            s = scan_starts(data, p, params.case_sensitive, params.whole_word)
            starts_list.append(s)
            ends_list.append(s + len(p))
        starts = np.concatenate(starts_list) if starts_list else np.zeros(0, np.int64)
        ends = np.concatenate(ends_list) if ends_list else np.zeros(0, np.int64)

        if params.count_lines_mode:
            u = np.unique(starts)
            nl = resolve.newline_positions_host(data)
            nat = _nat()
            if nat is not None:
                lines = nat.distinct_lines(
                    np.ascontiguousarray(u, np.int64),
                    np.ascontiguousarray(nl, np.int64),
                )
            else:
                lines = len(np.unique(np.searchsorted(nl, u, side="left")))
            return SearchResult(
                min(lines, mc) if mc is not None else lines, _EMPTY_POS, n
            )

        positions = resolve.ac_order_truncate(
            starts, ends, mc, final_sort=params.sorted_positions
        )
        return SearchResult(len(positions), positions, n)


# ---- break-even calibration -------------------------------------------


def _calib_corpus(size: int) -> np.ndarray:
    rng = np.random.default_rng(99)
    words = (
        b"the quick brown fox jumps over a lazy dog and then some more "
        b"words it was time for Sherlock to breathe deeply in the theatre"
    ).split()
    parts, total = [], 0
    while total < size:
        idx = rng.integers(0, len(words), 8)
        line = b" ".join(words[i] for i in idx) + b"\n"
        parts.append(line)
        total += len(line)
    return np.frombuffer(b"".join(parts), np.uint8)[:size]


def calibrate(
    force: bool = False, verbose: bool = False, device=None, *,
    big_bytes: int = 8 << 20, small_bytes: int = 1 << 20,
) -> dict:
    """Measure host scan rate and device overhead+rate once; cache the
    solved break-even on disk (per machine and device). `device` follows
    dispatch.resolve_device: the card unless the caller asks for the CPU,
    and no card raises. Returns the record."""
    path = _cache_path()
    if not force:
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            pass

    import torch

    from . import dispatch

    dev = dispatch.resolve_device(device)
    pat = b"the"
    big = _calib_corpus(big_bytes)
    small = big[:small_bytes]

    def _host_time(buf):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            scan_count(buf, pat, True, False, count_lines=True)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    host_rate = len(big) / max(_host_time(big), 1e-9)

    def _dev_time(buf):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            staged = dispatch.stage(buf, dev)
            totals, _, _ = dispatch.scan_literal_staged(
                staged, pattern=pat, case_sensitive=True, whole_word=False,
                want_mask=False,
            )
            int(totals[1])  # the matched lines, read back: the scan is done
            ts.append(time.perf_counter() - t0)
        return min(ts)

    _dev_time(small)  # warm both bucket shapes (pinned buffers, the kernels)
    _dev_time(big)
    t_small = _dev_time(small)
    t_big = _dev_time(big)
    dn = len(big) - len(small)
    dev_rate = dn / max(t_big - t_small, 1e-9)
    dev_overhead = max(t_small - len(small) / dev_rate, 0.0)

    if dev_rate <= host_rate or dev_overhead <= 0:
        breakeven = BREAKEVEN_CAP  # the device never wins end-to-end here
    else:
        breakeven = int(dev_overhead / (1.0 / host_rate - 1.0 / dev_rate))
        breakeven = min(max(breakeven, 1 << 20), BREAKEVEN_CAP)

    rec = {
        "breakeven_bytes": breakeven,
        "host_gbps": round(host_rate / 1e9, 3),
        "device_overhead_s": round(dev_overhead, 4),
        "device_gbps": round(dev_rate / 1e9, 3),
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f)
    except Exception:
        pass
    global _threshold_cache
    _threshold_cache = None
    if verbose or os.environ.get("KREP_TPU_PROFILE") == "1":
        sys.stderr.write(f"krep-tpu: break-even calibration: {rec}\n")
    return rec
