"""Large pattern sets (K > FUSED_MAX).

Port of krep_tpu/ops/dfa.py's default route, `_grouped_swar`: one routed
device pass per group (Hamming passes of up to 256 patterns when the set
qualifies, else fused passes of 64), union masks OR-merged on the device,
attribution and line accounting as in ops/multi.py. The dense-DFA opt-in
(KREP_TPU_DFA=1, krep_tpu/ops/ac.py) is not ported.
"""

from __future__ import annotations

from krep_tpu.engine.search import _EMPTY_POS, SearchResult
from krep_tpu.params import SearchParams

from . import dispatch, multi


def search_dfa(params: SearchParams, text, patterns, device) -> SearchResult:
    """Search for more than FUSED_MAX non-empty `patterns` (krep_tpu's
    search_dfa without KREP_TPU_DFA=1, i.e. its `_grouped_swar`)."""
    n = len(text)
    staged = dispatch.stage(text, device)
    mc = params.max_count
    cs, ww = params.case_sensitive, params.whole_word

    if params.count_matches_mode:
        total = multi.fused_count_device(staged, patterns, cs, ww, max_count=mc)
        return SearchResult(multi.cap(total, mc), _EMPTY_POS, n)
    if params.count_lines_mode:
        lines = multi.fused_lines_device(staged, patterns, cs, ww)
        return SearchResult(multi.cap(lines, mc), _EMPTY_POS, n)
    mask, group_counts = multi.fused_union_mask_device(staged, patterns, cs, ww)
    anchors = dispatch.starts_from_device_mask(mask, n, group_counts)
    return multi.resolve_positions(params, dispatch.as_u8(text), anchors, patterns)
