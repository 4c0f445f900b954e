"""search_string / search_file for the literal paths (one pattern, or
several: -e/-f).

Port of krep_tpu/engine/search.py: stage bytes to the device, run the fused
scans (ops/swar.py, ops/multi.py — the CUDA kernels on a CUDA device, their
plain PyTorch versions on the CPU), and resolve the start masks to
reference-exact counts and positions with the host stage
(engine/resolve.py, copied from krep_tpu).

Everything here takes an explicit `device` (default: $KREP_TORCH_DEVICE,
else "cuda"). On a machine with more than one CUDA device, texts of 64 KiB
and more shard across the devices (parallel/mesh.py) unless -t is 1, as
krep_tpu shards across its mesh. Regex is not ported yet and raises
NotImplementedError.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import dispatch, hostscan
from ..params import MAX_PATTERN_LENGTH, Algorithm, MatchPolicy, SearchParams
from ..parallel.lines import LineCountCombiner, _is_word_byte
from . import resolve
from .select import Selection, select_algorithm


class PatternValidationError(Exception):
    """A literal pattern set rejected at search entry (exit code 2).

    Mirrors the reference's dual message forms: search_file prefixes the
    target ("krep: <target>: Error: ..." — krep.c:2298-2322, including
    stdin as "-"), search_string emits the bare "Error: ..." form
    (krep.c:2030-2047). `core` is the unprefixed message so callers that
    report per-target (the -r walker) can re-prefix it per file.
    """

    def __init__(self, core: str, target: str | None = None):
        self.core = core
        self.message = core if target is None else f"krep: {target}: {core}"
        super().__init__(self.message)


def validate_patterns(params: SearchParams, target: str | None = None) -> None:
    """Literal pattern-set validation at search entry (krep.c:2298-2322 for
    file/stdin targets, krep.c:2030-2047 for string search). Regex patterns
    are exempt — they go to regcomp instead. First offending pattern wins."""
    if params.use_regex:
        return
    for p in params.patterns:
        if len(p) == 0:
            if params.num_patterns > 1:
                raise PatternValidationError(
                    "Error: Empty pattern provided for literal search "
                    "with multiple patterns.",
                    target,
                )
            continue  # a single empty pattern is allowed
        if len(p) > MAX_PATTERN_LENGTH:
            raise PatternValidationError(
                f"Error: Pattern '{p.decode('latin-1')}' too long "
                f"(max {MAX_PATTERN_LENGTH}).",
                target,
            )


@dataclass
class SearchResult:
    """What krep reports for one text: a count plus tracked positions.

    `count` is mode-dependent, mirroring the kernel return contract
    (krep.h:98-101): matched-line count in -c mode, match count otherwise.
    positions is an (k, 2) int64 array of (start, end) byte offsets, sorted
    by (start, end) like the merge qsort at krep.c:3020-3023 / 420-434.
    """

    count: int
    positions: np.ndarray  # (k, 2) int64
    text_len: int
    error: bool = False

    @property
    def matched(self) -> bool:
        return self.count > 0


_EMPTY_POS = np.zeros((0, 2), dtype=np.int64)


def _is_word_np(b: np.ndarray) -> np.ndarray:
    return (
        ((b >= 0x30) & (b <= 0x39))
        | ((b >= 0x41) & (b <= 0x5A))
        | ((b >= 0x61) & (b <= 0x7A))
        | (b == 0x5F)
    )


def _memchr_short_o(
    params: SearchParams, text, force_python: bool = False
) -> SearchResult:
    """Host emulation of memchr_short_search in -o mode (krep.c:4371-4503):
    its candidate-skip advance drops some matches, and that observable
    behavior must be reproduced (see resolve.memchr_short_o_walk).
    The hot implementation is one native C pass (SWAR-block candidate
    detection + verify); the numpy pipeline below is the no-toolchain
    fallback and the semantics oracle the C pass is tested against
    (force_python)."""
    buf = np.frombuffer(text, np.uint8) if isinstance(text, (bytes, bytearray)) else np.asarray(text)
    n = buf.shape[0]
    pat = np.frombuffer(params.pattern, np.uint8)
    m = len(pat)

    try:
        from ..native import runtime as _native
    except Exception:
        _native = None
    if force_python:
        _native = None
    if _native is not None and m <= 16:
        kept = _native.memchr_short_o_scan(
            buf, params.pattern, not params.case_sensitive,
            params.whole_word, params.max_count,
        )
        kept = resolve.truncate_max_count(kept, params.max_count)
        positions = np.stack([kept, kept + m], axis=1).astype(np.int64)
        return SearchResult(len(kept), positions, n)
    t = buf
    if not params.case_sensitive:
        upper = (t >= 0x41) & (t <= 0x5A)
        t = np.where(upper, t + 32, t)
        pu = (pat >= 0x41) & (pat <= 0x5A)
        pat = np.where(pu, pat + 32, pat)
    cands = np.flatnonzero(t[: n - m + 1] == pat[0])
    verified = np.ones(len(cands), dtype=bool)
    for j in range(1, m):
        verified &= t[cands + j] == pat[j]
    if params.whole_word:
        before_ok = np.ones(len(cands), dtype=bool)
        nz = cands > 0
        before_ok[nz] = ~_is_word_np(buf[cands[nz] - 1])
        after_ok = np.ones(len(cands), dtype=bool)
        inr = cands + m < n
        after_ok[inr] = ~_is_word_np(buf[cands[inr] + m])
        word_ok = before_ok & after_ok
    else:
        word_ok = np.ones(len(cands), dtype=bool)
    kept = resolve.memchr_short_o_walk(cands, verified, word_ok, m)
    kept = resolve.truncate_max_count(kept, params.max_count)
    positions = np.stack([kept, kept + m], axis=1).astype(np.int64)
    return SearchResult(len(kept), positions, n)


# Single-array scans use int32 offsets; larger inputs stream through the
# device in slabs with halo stitching (overridable for tests).
SLAB_BYTES = int(os.environ.get("KREP_TPU_SLAB_BYTES", 1 << 30))
LONG_PATTERN = 64  # beyond this the device scans a prefix, the host verifies
EARLY_EXIT_SLAB = 64 << 20  # slab size when -m makes early termination likely


def _kept_bound_increment(starts: np.ndarray, m: int, policy, n: int, state: dict) -> int:
    """Exact count of policy-surviving matches contributed by one drained
    slab's starts (slabs arrive in text order), for -m early exit. `state`
    carries the greedy non-overlap cursor across slabs; VECTOR_TAIL policies
    only count the all-matches head region (< cut) — a safe lower bound,
    since truncation takes matches in text order (krep.c:2950-2962)."""
    if policy is MatchPolicy.ALL:
        return len(starts)
    if policy in (MatchPolicy.VECTOR_TAIL32, MatchPolicy.VECTOR_TAIL64):
        window = 32 if policy is MatchPolicy.VECTOR_TAIL32 else 64
        cut = n - (n % window)
        return int(np.count_nonzero(starts < cut))
    # NONOVERLAP: incremental greedy, bounded by the remaining budget
    kept = 0
    next_ok = state.get("next_ok", -1)
    budget = state.get("budget", 1 << 62)
    i = int(np.searchsorted(starts, next_ok, side="left"))
    while i < len(starts) and kept < budget:
        s = int(starts[i])
        kept += 1
        next_ok = s + m
        i = int(np.searchsorted(starts, next_ok, side="left"))
    state["next_ok"] = next_ok
    return kept


def _finish_longpat(
    params: SearchParams, data: np.ndarray, cands: np.ndarray, policy
) -> SearchResult:
    """Host verification + resolution at the device-filtered candidate
    starts (shared by the slabbed and sharded long-pattern paths)."""
    n = data.shape[0]
    m = len(params.pattern)
    max_count = params.max_count
    starts, _ = resolve.attribute_patterns(
        data, cands, (params.pattern,),
        case_sensitive=params.case_sensitive,
        whole_word=params.whole_word,
        anchor="start",
    )

    if params.count_lines_mode:
        nl = resolve.newline_positions_host(data)
        try:
            from ..native import runtime as _native

            lines = _native.distinct_lines(
                np.ascontiguousarray(starts, np.int64),
                np.ascontiguousarray(nl, np.int64),
            )
        except Exception:
            lines = len(np.unique(np.searchsorted(nl, starts, side="left")))
        return SearchResult(
            min(lines, max_count) if max_count is not None else lines, _EMPTY_POS, n
        )

    starts = resolve.apply_policy(starts, m, policy, n)
    starts = resolve.truncate_max_count(starts, max_count)
    if params.count_matches_mode:
        return SearchResult(len(starts), _EMPTY_POS, n)
    positions = np.stack([starts, starts + m], axis=1).astype(np.int64)
    return SearchResult(len(starts), positions, n)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} not ported to krep_tpu_torch yet")


SHARD_MIN_BYTES = 1 << 16  # texts from this size shard when the machine has several devices


def _shards(device: torch.device, n: int, threads: int | None) -> bool:
    """krep_tpu's sharding rule (engine/search.py:538): more than one
    device of `device`'s kind, a text of 64 KiB or more, and -t other than
    1 (-t 1 forces the single-device path, like the reference's inline
    single-chunk run, krep.c:2764)."""
    from ..parallel import mesh

    return len(mesh.devices(device)) > 1 and n >= SHARD_MIN_BYTES and threads != 1


def _mesh_for_threads(threads: int | None, device: torch.device) -> tuple:
    """Map the reference's -t thread count onto the device mesh: auto
    (None) uses every device (the reference's online-cores default,
    krep.c:2729-2762); an explicit -t caps the shard count the same way the
    reference caps its chunk threads. A CPU `device` gives the one CPU."""
    from ..parallel import mesh

    devs = mesh.devices(device)
    d = len(devs) if threads is None else max(1, min(threads, len(devs)))
    return devs[:d]


def _search_single_literal_sharded(
    params: SearchParams, text, policy, device: torch.device,
    threads: int | None = None,
) -> SearchResult:
    """One literal sharded across the mesh of _mesh_for_threads: the
    reference's thread pool analogue (krep.c:2851-2905)."""
    from ..parallel import mesh as mesh_mod

    m = len(params.pattern)
    n = len(text)
    max_count = params.max_count
    data = dispatch.as_u8(text)

    need_positions = params.track_positions and not params.count_matches_mode
    want_mask = need_positions or (
        not params.count_lines_mode and policy is not MatchPolicy.ALL
    )
    count, lines, starts = mesh_mod.sharded_scan(
        data,
        params.pattern,
        case_sensitive=params.case_sensitive,
        whole_word=params.whole_word,
        want_mask=want_mask,
        mesh=_mesh_for_threads(threads, device),
    )
    if params.count_lines_mode:
        c = min(lines, max_count) if max_count is not None else lines
        return SearchResult(c, _EMPTY_POS, n)
    if not want_mask:
        c = min(count, max_count) if max_count is not None else count
        return SearchResult(c, _EMPTY_POS, n)
    starts = resolve.apply_policy(starts, m, policy, n)
    starts = resolve.truncate_max_count(starts, max_count)
    if params.count_matches_mode:
        return SearchResult(len(starts), _EMPTY_POS, n)
    positions = np.stack([starts, starts + m], axis=1).astype(np.int64)
    return SearchResult(len(starts), positions, n)


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
    params: SearchParams, text, policy, device: torch.device,
    threads: int | None = None,
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
    if _shards(device, n, threads):
        # several devices: the prefix filter shards across the mesh like
        # any short literal (krep.c:2851-2905); the host check is unchanged
        from ..parallel import mesh as mesh_mod

        _, _, cands = mesh_mod.sharded_scan(
            data, prefix, case_sensitive=params.case_sensitive,
            whole_word=False, want_mask=True,
            mesh=_mesh_for_threads(threads, device),
        )
        return _finish_longpat(params, data, cands, policy)
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
        return _search_single_literal_longpat(params, text, policy, device, threads)

    if _shards(device, n, threads):
        # several devices: shard the bytes across the mesh, before the
        # slab loop, as krep_tpu does (engine/search.py:538)
        return _search_single_literal_sharded(params, text, policy, device, threads)

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
    from ..ops import multi  # imports this module

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
    from ..io import files

    data = files.read_bytes(path)
    return search_string(params, data, threads, target=path, device=device)
