"""search_string / search_file for the literal paths (one pattern, or
several: -e/-f).

Port of krep_tpu/engine/search.py: stage bytes to the device, run the fused
scans (ops/swar.py, ops/multi.py — the CUDA kernels on a CUDA device, their
plain PyTorch versions on the CPU), and resolve the start masks to
reference-exact counts and positions with the shared host stage
(krep_tpu.engine.resolve).

Everything here takes an explicit `device` (default: $KREP_TORCH_DEVICE,
else "cuda"). Regex and multi-GPU sharding are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from krep_tpu.engine import resolve
from krep_tpu.engine.search import (
    _EMPTY_POS,
    SearchResult,
    _finish_longpat,
    _kept_bound_increment,
    _memchr_short_o,
    validate_patterns,
)
from krep_tpu.engine.select import Selection, select_algorithm
from krep_tpu.ops import hostscan
from krep_tpu.params import Algorithm, MatchPolicy, SearchParams

from ..ops import dispatch, multi
from ..parallel.lines import LineCountCombiner, _is_word_byte

# Single-array scans use int32 offsets; larger inputs stream through the
# device in slabs with halo stitching (overridable for tests).
SLAB_BYTES = int(os.environ.get("KREP_TPU_SLAB_BYTES", 1 << 30))
LONG_PATTERN = 64  # beyond this the device scans a prefix, the host verifies
EARLY_EXIT_SLAB = 64 << 20  # slab size when -m makes early termination likely


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} not ported to krep_tpu_torch yet")


def check_single_device(device: torch.device, n: int, threads: int | None) -> None:
    """Where krep_tpu would shard over several devices (more than one, a
    text of 64 KiB or more, -t other than 1), raise: multi-GPU sharding is
    not ported."""
    if (
        device.type == "cuda"
        and torch.cuda.device_count() > 1
        and n >= (1 << 16)
        and threads != 1
    ):
        raise _not_ported("multi-GPU sharding")


def _device_scan_literal(staged, pattern, params, want_mask):
    """Run the fused device scan; returns (all_count, line_count, starts)."""
    totals, mask, group_counts = dispatch.scan_literal_staged(
        staged,
        pattern=pattern,
        case_sensitive=params.case_sensitive,
        whole_word=params.whole_word,
        want_mask=want_mask,
    )
    count, lines = totals[:2].tolist()
    starts = None
    if want_mask:
        starts = dispatch.starts_from_device_mask(mask, staged.n, group_counts)
    return count, lines, starts


def _search_single_literal_slabbed(
    params: SearchParams, text, policy, device: torch.device,
    slab_bytes: int | None = None,
) -> SearchResult:
    """Host-side slab loop for texts beyond the single-array size: each slab
    is scanned with the shard stats ((m-1)-byte halo appended, the
    reference's chunk overlap, krep.c:2837-2846) and merged exactly.

    With -m the loop stops launching slabs once the cap is provably reached
    (krep.c:1366-1367 lifted to slab granularity): line counts merge
    monotonically (LineCountCombiner), match counts are monotone, and
    position caps use an incremental policy cursor. Up to WINDOW slabs are
    in flight: launches are asynchronous on the current CUDA stream, so
    staging the next slab overlaps the scan of the previous ones."""
    data = dispatch.as_u8(text)
    n = data.shape[0]
    m = len(params.pattern)
    max_count = params.max_count
    slab_bytes = slab_bytes or SLAB_BYTES

    need_positions = params.track_positions and not params.count_matches_mode
    want_mask = need_positions or (
        not params.count_lines_mode and policy is not MatchPolicy.ALL
    )

    total = 0
    combiner = LineCountCombiner()
    all_starts = []
    pending = []
    WINDOW = 2  # slabs in flight: overlap staging/compute, bound device memory
    kept_bound = 0  # policy-surviving matches so far (for -m early exit)
    policy_state = {"budget": max_count if max_count is not None else (1 << 62)}

    def drain(entry):
        nonlocal total, kept_bound
        pos_, owned_, (totals, mask, group_counts) = entry
        c, f, trail, lead, hasnl = totals[:5].tolist()
        total += c
        combiner.push(f, lead, trail, c > 0, hasnl)
        if want_mask:
            starts = dispatch.starts_from_device_mask(mask, owned_, group_counts) + pos_
            all_starts.append(starts)
            if max_count is not None:
                kept_bound += _kept_bound_increment(starts, m, policy, n, policy_state)

    def capped() -> bool:
        if max_count is None:
            return False
        if params.count_lines_mode:
            return combiner.total >= max_count
        if not want_mask:
            return total >= max_count
        return kept_bound >= max_count

    pos = 0
    while pos < n:
        owned = min(slab_bytes, n - pos)
        # halo: m-1 bytes to finish boundary matches + 1 byte so the
        # whole-word after-check at the last owned start sees real text
        slab = data[pos : min(pos + owned + m, n)]
        tl = min(owned + m - 1, len(slab))
        prev = 0
        if pos > 0 and params.whole_word:
            prev = int(_is_word_byte(int(data[pos - 1])))
        # line accounting stops at the owned region (start_limit=owned):
        # halo newlines belong to the NEXT slab
        staged = dispatch.stage(slab, device, true_len=tl)
        outs = dispatch.scan_literal_staged(
            staged,
            pattern=params.pattern,
            case_sensitive=params.case_sensitive,
            whole_word=params.whole_word,
            want_mask=want_mask,
            prev_word=prev,
            start_limit=owned,
        )
        pending.append((pos, owned, outs))
        if len(pending) > WINDOW:
            drain(pending.pop(0))
            if capped():
                pending = []  # cap reached: later slabs can't change output
                break
        pos += owned
    for entry in pending:
        drain(entry)
        if capped():
            break

    if params.count_lines_mode:
        lines = combiner.total
        c = min(lines, max_count) if max_count is not None else lines
        return SearchResult(c, _EMPTY_POS, n)
    if not want_mask:
        c = min(total, max_count) if max_count is not None else total
        return SearchResult(c, _EMPTY_POS, n)
    starts = np.concatenate(all_starts) if all_starts else np.zeros(0, np.int64)
    starts = resolve.apply_policy(starts, m, policy, n)
    starts = resolve.truncate_max_count(starts, max_count)
    if params.count_matches_mode:
        return SearchResult(len(starts), _EMPTY_POS, n)
    positions = np.stack([starts, starts + m], axis=1).astype(np.int64)
    return SearchResult(len(starts), positions, n)


def _search_single_literal_longpat(
    params: SearchParams, text, policy, device: torch.device
) -> SearchResult:
    """Patterns longer than the kernel's 64 bytes: the device scans the
    first LONG_PATTERN bytes as a filter (still exact on its prefix), the
    host verifies the remaining bytes at the (sparse) candidate starts —
    the translation of 'long patterns go to scalar BMH'
    (SIMD_MAX_PATTERN_LEN, krep.c:99-113)."""
    data = dispatch.as_u8(text)
    n = data.shape[0]
    # whole-word before-check is prefix-position exact; the after-check
    # depends on the full length, so word filtering is left to the host
    prefix = params.pattern[:LONG_PATTERN]
    cand_parts = []
    pos = 0
    while pos < n:
        owned = min(SLAB_BYTES, n - pos)
        slab = data[pos : min(pos + owned + len(prefix) - 1, n)]
        staged = dispatch.stage(slab, device)
        _, mask, group_counts = dispatch.scan_literal_staged(
            staged,
            pattern=prefix,
            case_sensitive=params.case_sensitive,
            whole_word=False,
            want_mask=True,
        )
        cs = dispatch.starts_from_device_mask(mask, len(slab), group_counts)
        cand_parts.append(cs[cs < owned] + pos)
        pos += owned
    cands = np.concatenate(cand_parts) if cand_parts else np.zeros(0, np.int64)
    return _finish_longpat(params, data, cands, policy)


def _search_single_literal(
    params: SearchParams, text, sel: Selection, device: torch.device,
    threads: int | None = None,
) -> SearchResult:
    m = len(params.pattern)
    n = len(text)
    if m == 0 or n < m:
        return SearchResult(0, _EMPTY_POS, n)

    if (
        sel.algorithm is Algorithm.MEMCHR_SHORT
        and params.only_matching
        and not params.count_lines_mode
    ):
        # the reference's memchr_short -o skip drops some matches; that
        # observable behaviour is emulated on the host (krep.c:4371-4503)
        return _memchr_short_o(params, text)

    policy = sel.policy(params.only_matching)

    # below the device break-even a native host scan wins outright (no
    # staging transfer, no launch latency) — krep.c:3402-3430
    if hostscan.route_small(n):
        return hostscan.search_single_host(params, text, policy)

    if m > LONG_PATTERN:
        return _search_single_literal_longpat(params, text, policy, device)

    check_single_device(device, n, threads)

    max_count = params.max_count
    if n > SLAB_BYTES:
        return _search_single_literal_slabbed(params, text, policy, device)
    if (
        max_count is not None
        and max_count < (1 << 20)
        and n > 2 * EARLY_EXIT_SLAB
    ):
        # small -m cap on a large text: stream small slabs so the scan can
        # stop at the cap (krep.c:1366-1367) instead of paying the full text
        return _search_single_literal_slabbed(
            params, text, policy, device, slab_bytes=EARLY_EXIT_SLAB
        )

    staged = dispatch.stage(text, device)

    if params.count_lines_mode:
        # -c: distinct matched lines, capped by -m (krep.c:1331-1351)
        _, lines, _ = _device_scan_literal(
            staged, params.pattern, params, want_mask=False
        )
        count = min(lines, max_count) if max_count is not None else lines
        return SearchResult(count, _EMPTY_POS, n)

    need_positions = params.track_positions and not params.count_matches_mode
    want_mask = need_positions or policy is not MatchPolicy.ALL
    all_count, _, starts = _device_scan_literal(
        staged, params.pattern, params, want_mask=want_mask
    )

    if policy is MatchPolicy.ALL and not need_positions:
        count = min(all_count, max_count) if max_count is not None else all_count
        return SearchResult(count, _EMPTY_POS, n)

    starts = resolve.apply_policy(starts, m, policy, n)
    starts = resolve.truncate_max_count(starts, max_count)
    positions = np.stack([starts, starts + m], axis=1).astype(np.int64)
    return SearchResult(len(starts), positions, n)


def _search_multi_literal(
    params: SearchParams, text, device: torch.device, threads: int | None = None,
) -> SearchResult:
    """Several patterns (-e/-f): the native host scan below the break-even,
    whose cost is K passes (so it compares K*n bytes), else the device."""
    patterns = tuple(p for p in params.patterns if len(p) > 0)
    n = len(text)
    if not patterns or n == 0:
        return SearchResult(0, _EMPTY_POS, n)
    if hostscan.route_small(n, len(patterns)):
        return hostscan.search_multi_host(params, text, patterns)
    return multi.search_multi(params, text, patterns, device, threads)


def search_string(
    params: SearchParams, text, threads: int | None = None,
    target: str | None = None, device: str | torch.device | None = None,
) -> SearchResult:
    """Mirror of search_string (krep.c:1999-2246): single-shot search of an
    in-memory byte string. `target` names the file/stdin source for
    validation messages (None = bare string search, the -s form); raises
    PatternValidationError on invalid literal pattern sets."""
    if isinstance(text, str):
        text = text.encode()
    dev = dispatch.resolve_device(device)
    validate_patterns(params, target)

    sel = select_algorithm(params)
    if sel.algorithm is Algorithm.REGEX:
        raise _not_ported("regex search (-E)")
    if sel.algorithm is Algorithm.AHO_CORASICK:
        return _search_multi_literal(params, text, dev, threads)
    return _search_single_literal(params, text, sel, dev, threads)


def search_file(
    params: SearchParams, path: str, threads: int | None = None,
    device: str | torch.device | None = None,
) -> SearchResult:
    """Mirror of search_file (krep.c:2274-3066)."""
    # validation precedes any I/O (krep.c:2298 runs before the stdin read
    # at 2325 and the open/mmap at 2625)
    validate_patterns(params, path)
    if path == "-":
        data = sys.stdin.buffer.read()
        # stdin text_len is strlen(text) (krep.c:2025, 2392): data
        # truncates at the first NUL
        nul = data.find(b"\0")
        if nul != -1:
            data = data[:nul]
        return search_string(
            params.with_(sorted_positions=False), data, threads, target=path,
            device=device,
        )
    from krep_tpu.io import files

    data = files.read_bytes(path)
    return search_string(params, data, threads, target=path, device=device)
