"""Multi-pattern literal search (the Aho-Corasick capability).

Port of krep_tpu/ops/multi.py on its device route. As there, K patterns
are not walked as a DFA but scanned in fused passes, and the count is the
sum of the per-pattern all-starts counts (the reference's own tests assert
AC count == sum of per-pattern counts, test_multiple_patterns.c:345-471).
Two kernels carry the passes:
  * up to 64 patterns per pass: the fused K-pattern scan
    (dispatch.scan_multi_staged, csrc/multi_scan.cu);
  * from MXU_MIN_K = 32 patterns of 1..29 NUL-free bytes up: the Hamming
    products on the int8 tensor cores (mxu.scan_count,
    csrc/hamming_scan.cu), up to 256 patterns per pass; their -c chains the
    union mask into the lines kernel (swar.lines_blocks), or with
    KREP_TPU_MXU_LINES=inkernel counts the lines in the Hamming kernel.
Positions come from the union start mask, attributed to patterns on the
host and truncated in AC emission order by engine/resolve.py. The
caller's pattern tuple (not the Hamming tables' shorts-first order) is the
one attributed.

There is one route per device (CUDA kernels on a CUDA device, their plain
versions on the CPU). On a machine with several devices, every mode shards
across them (`_search_multi_sharded`, parallel/mesh.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine import resolve
from ..engine.search import _EMPTY_POS, SearchResult
from ..parallel import mesh as mesh_mod
from ..params import SearchParams
from . import dispatch, mxu, swar

FUSED_MAX = swar.MAX_PATTERNS  # patterns per fused pass


def _mxu_eligible(patterns) -> bool:
    """The Hamming route's guard (multi.py:80): K >= MXU_MIN_K and every
    member 1..MAX_LEN_LONG bytes and NUL-free (a NUL would match the zero
    padding past true_len, which the non-strict products rely on)."""
    return len(patterns) >= mxu.MXU_MIN_K and all(
        0 < len(p) <= mxu.MAX_LEN_LONG and 0 not in p for p in patterns
    )


def _groups(patterns, size: int):
    return [patterns[i : i + size] for i in range(0, len(patterns), size)]


def cap(count: int, max_count: int | None) -> int:
    return min(count, max_count) if max_count is not None else count


def fused_count_device(staged, patterns, case_sensitive, whole_word, max_count=None,
                       strict=False) -> int:
    """Total ALL-overlap count of K patterns: Hamming passes when the set
    qualifies, else fused passes of FUSED_MAX. Multi-pass runs stop once
    max_count is reached (krep.c:2950-2962's budget capping). strict=True
    bounds the Hamming passes' starts against staged.true_len explicitly,
    which a StagedText.with_len view whose tail holds live text needs (the
    fused pass bounds its starts by true_len anyway)."""
    if _mxu_eligible(patterns):
        groups = _groups(patterns, mxu.MXU_MAX_PASS)

        def scan(g):
            return mxu.scan_count(
                staged, patterns=g, case_sensitive=case_sensitive, whole_word=whole_word,
                strict=strict,
            )[0]
    else:
        groups = _groups(patterns, FUSED_MAX)

        def scan(g):
            return dispatch.scan_multi_staged(
                staged, patterns=g, case_sensitive=case_sensitive,
                whole_word=whole_word, want_mask=False,
            )[0][0]
    total = 0
    for i, g in enumerate(groups):
        total = total + scan(g).to(torch.int64)
        if max_count is not None and i + 1 < len(groups) and int(total) >= max_count:
            break
    return int(total)


def fused_union_mask_device(staged, patterns, case_sensitive, whole_word):
    """Union start mask (u8 0/1 over the staged body) of K patterns and its
    per-64 KiB group counts (non-zero exactly where the mask has a set
    byte), routed as fused_count_device routes."""
    if _mxu_eligible(patterns):
        parts = [
            mxu.scan_count(
                staged, patterns=g, case_sensitive=case_sensitive,
                whole_word=whole_word, want_mask=True,
            )[1:]
            for g in _groups(patterns, mxu.MXU_MAX_PASS)
        ]
    else:
        parts = [
            dispatch.scan_multi_staged(
                staged, patterns=g, case_sensitive=case_sensitive,
                whole_word=whole_word, want_mask=True,
            )[1:]
            for g in _groups(patterns, FUSED_MAX)
        ]
    mask, group_counts = parts[0]
    for m, c in parts[1:]:
        mask |= m
        group_counts = group_counts + c
    return mask, group_counts


def fused_lines_device(staged, patterns, case_sensitive, whole_word) -> int:
    """Matched-line count of the K-pattern union on the device: the union
    mask chained into the lines kernel, whose last block folds the line
    count, so only scalars leave the card (the reference's AC counts lines in-stream,
    aho_corasick.c:390-403). With KREP_TPU_MXU_LINES=inkernel, a
    Hamming-eligible set of at most MXU_MAX_PASS patterns over a text with
    a zero tail counts its lines in the Hamming kernel instead, with no
    mask (krep_tpu's multi.py:189-200)."""
    if (
        os.environ.get("KREP_TPU_MXU_LINES") == "inkernel"
        and _mxu_eligible(patterns)
        and len(patterns) <= mxu.MXU_MAX_PASS
        and staged.tail_zero
    ):
        return int(mxu.scan_count(
            staged, patterns=tuple(patterns), case_sensitive=case_sensitive,
            whole_word=whole_word, want_lines=True,
        )[1])
    mask, _ = fused_union_mask_device(staged, patterns, case_sensitive, whole_word)
    _, totals = swar.lines_blocks(staged.u8, mask, staged.n_blocks)
    return int(totals[1])


def resolve_positions(params: SearchParams, data: np.ndarray, anchors, patterns) -> SearchResult:
    """Attribute union start anchors to the patterns (with multiplicity,
    whole-word checked) and truncate in AC emission order."""
    starts, ends = resolve.attribute_patterns(
        data, anchors, patterns,
        case_sensitive=params.case_sensitive, whole_word=params.whole_word,
        anchor="start",
    )
    positions = resolve.ac_order_truncate(
        starts, ends, params.max_count, final_sort=params.sorted_positions
    )
    if params.count_mode:
        return SearchResult(len(positions), _EMPTY_POS, len(data))
    return SearchResult(len(positions), positions, len(data))


def _search_multi_swar(params: SearchParams, text, patterns, device) -> SearchResult:
    """K <= FUSED_MAX patterns, all of them <= 64 bytes, one staged array."""
    n = len(text)
    staged = dispatch.stage(text, device)
    mc = params.max_count

    if params.count_lines_mode:
        if _mxu_eligible(patterns):
            lines = fused_lines_device(
                staged, patterns, params.case_sensitive, params.whole_word
            )
        else:
            totals, _, _ = dispatch.scan_multi_staged(
                staged, patterns=patterns, case_sensitive=params.case_sensitive,
                whole_word=params.whole_word, want_mask=False,
            )
            lines = int(totals[1])
        return SearchResult(cap(lines, mc), _EMPTY_POS, n)

    if params.count_matches_mode:
        total = fused_count_device(staged, patterns, params.case_sensitive, params.whole_word)
        return SearchResult(cap(total, mc), _EMPTY_POS, n)

    mask, group_counts = fused_union_mask_device(
        staged, patterns, params.case_sensitive, params.whole_word
    )
    anchors = dispatch.starts_from_device_mask(mask, n, group_counts)
    return resolve_positions(params, dispatch.as_u8(text), anchors, patterns)


def _search_multi_mixed(params: SearchParams, text, patterns, device) -> SearchResult:
    """Sets with members over 64 bytes, or texts over SLAB_BYTES: in slabs,
    short members scan fused and long members scan their 64-byte prefix as
    a filter; the union of candidate starts is attributed and verified on
    the host (exact, any K). A slab edge looks like a text edge to the -w
    test, which only admits candidates; the host check is exact."""
    from ..engine import search as engine

    data = dispatch.as_u8(text)
    n = data.shape[0]
    long_pattern = engine.LONG_PATTERN
    shorts = tuple(p for p in patterns if len(p) <= long_pattern)
    longs = tuple(p for p in patterns if len(p) > long_pattern)
    pieces = []
    pos = 0
    while pos < n:
        owned = min(engine.SLAB_BYTES, n - pos)
        slab = data[pos : min(pos + owned + long_pattern, n)]
        staged = dispatch.stage(slab, device)
        for g in _groups(shorts, FUSED_MAX):
            _, mask, group_counts = dispatch.scan_multi_staged(
                staged, patterns=g, case_sensitive=params.case_sensitive,
                whole_word=params.whole_word, want_mask=True,
            )
            starts = dispatch.starts_from_device_mask(mask, len(slab), group_counts)
            pieces.append(starts[starts < owned] + pos)
        for p in longs:
            _, mask, group_counts = dispatch.scan_literal_staged(
                staged, pattern=p[:long_pattern], case_sensitive=params.case_sensitive,
                whole_word=False, want_mask=True,
            )
            starts = dispatch.starts_from_device_mask(mask, len(slab), group_counts)
            pieces.append(starts[starts < owned] + pos)
        pos += owned

    anchors = np.unique(np.concatenate(pieces)) if pieces else np.zeros(0, np.int64)
    if params.count_lines_mode:
        starts, _ = resolve.attribute_patterns(
            data, anchors, patterns, case_sensitive=params.case_sensitive,
            whole_word=params.whole_word, anchor="start",
        )
        nl = resolve.newline_positions_host(data)
        lines = len(np.unique(np.searchsorted(nl, starts, side="left")))
        return SearchResult(cap(lines, params.max_count), _EMPTY_POS, n)
    return resolve_positions(params, data, anchors, patterns)


def _search_multi_sharded(
    params: SearchParams, text, patterns, mesh,
) -> SearchResult:
    """K patterns sharded across `mesh` (engine._mesh_for_threads), krep_tpu's
    _search_multi_sharded (the reference's chunk threads sharing one
    read-only AC trie, krep.c:2524-2536): pure counts of a Hamming-eligible set through the
    Hamming kernel per shard, one fused group with exact line accounting
    in the mesh, else fused groups of shorts and of long members'
    prefixes whose union starts are attributed and verified on the host."""
    from ..engine import search as engine

    n = len(text)
    data = dispatch.as_u8(text)
    mc = params.max_count
    cs, ww = params.case_sensitive, params.whole_word
    need_positions = params.track_positions and not params.count_matches_mode

    if params.count_matches_mode and _mxu_eligible(patterns):
        # the Hamming products per shard: the multi-device route for
        # large-K pure counting (any K, unlike the fused pass's FUSED_MAX)
        total = mesh_mod.sharded_count(data, patterns, case_sensitive=cs, whole_word=ww, mesh=mesh)
        return SearchResult(cap(total, mc), _EMPTY_POS, n)

    shorts = tuple(p for p in patterns if len(p) <= engine.LONG_PATTERN)
    longs = tuple(p for p in patterns if len(p) > engine.LONG_PATTERN)

    if not longs and len(shorts) <= FUSED_MAX:
        # one fused group: exact in-mesh line accounting, no host pass
        total, lines, union_starts = mesh_mod.sharded_scan(
            data, patterns, case_sensitive=cs, whole_word=ww,
            want_mask=need_positions, mesh=mesh,
        )
        if params.count_lines_mode:
            return SearchResult(cap(lines, mc), _EMPTY_POS, n)
        if not need_positions:
            return SearchResult(cap(total, mc), _EMPTY_POS, n)
        return resolve_positions(params, data, union_starts, patterns)

    # Grouped route for everything else: any K, whole-word sets, members
    # over 64 bytes — FUSED_MAX-sized groups of shorts (and of the long
    # members' prefixes, a superset filter) each scan sharded across the
    # mesh; the union of candidate starts is attributed and verified on
    # the host, as on the single-device mixed route.
    if params.count_matches_mode and not longs:
        # group totals add exactly (the groups partition the pattern set
        # and AC's total is the sum of the per-pattern ALL counts)
        total = sum(
            mesh_mod.sharded_scan(data, g, case_sensitive=cs, whole_word=ww, mesh=mesh)[0]
            for g in _groups(shorts, FUSED_MAX)
        )
        return SearchResult(cap(total, mc), _EMPTY_POS, n)

    anchor_parts = [
        mesh_mod.sharded_scan(data, g, case_sensitive=cs, whole_word=ww, want_mask=True,
                              mesh=mesh)[2]
        for g in _groups(shorts, FUSED_MAX)
    ]
    for g in _groups(longs, FUSED_MAX):
        # prefixes scan without -w (the after-check at a prefix end means
        # nothing); the host attribution enforces exact boundaries
        prefixes = tuple(p[: engine.LONG_PATTERN] for p in g)
        anchor_parts.append(mesh_mod.sharded_scan(
            data, prefixes, case_sensitive=cs, want_mask=True, mesh=mesh)[2])
    anchors = np.unique(np.concatenate(anchor_parts)) if anchor_parts else np.zeros(0, np.int64)
    if params.count_lines_mode:
        starts, _ = resolve.attribute_patterns(
            data, anchors, patterns, case_sensitive=cs, whole_word=ww, anchor="start",
        )
        nl = resolve.newline_positions_host(data)
        lines = len(np.unique(np.searchsorted(nl, starts, side="left")))
        return SearchResult(cap(lines, mc), _EMPTY_POS, n)
    return resolve_positions(params, data, anchors, patterns)


def search_multi(params: SearchParams, text, patterns, device, threads: int | None = None) -> SearchResult:
    """Device search for the non-empty `patterns` of `params` over a
    non-empty text, routed as krep_tpu's search_multi routes on its SWAR
    backend: the sharded route on a machine with several devices (while a
    shard stays within SLAB_BYTES), the mixed slab route, the K > FUSED_MAX
    grouped route (ops/dfa.py), or one fused pass."""
    from ..engine import search as engine
    from . import dfa

    n = len(text)
    if engine._shards(device, n, threads):
        # -t shapes the shard count like the reference's chunk threads
        # (krep.c:2524-2536); -t 1 forces the single-device path
        mesh = engine._mesh_for_threads(threads, device)
        if -(-n // len(mesh)) <= engine.SLAB_BYTES:
            return _search_multi_sharded(params, text, patterns, mesh)
    if any(len(p) > engine.LONG_PATTERN for p in patterns) or len(text) > engine.SLAB_BYTES:
        return _search_multi_mixed(params, text, patterns, device)
    if len(patterns) > FUSED_MAX:
        return dfa.search_dfa(params, text, patterns, device)
    return _search_multi_swar(params, text, patterns, device)
