"""Exact matched-line merging across slabs and 64 KiB blocks.

Rewritten from krep_tpu/parallel/mesh.py:125-157, which imports jax. A run
of text scanned as if it began on a closed line reports
(count, first, trail, lead, has_nl) — see literal.shard_line_stats. Runs
merge in text order: a line that spans a boundary is counted by both sides
exactly when the left run's open line has a match (trail) and the right
run's leading segment has one (lead), so the merge subtracts one there.

`combine_block_stats` and `first_line_fixup` are the plain twins of the
CUDA scan tail's fold and first-line fix-up (csrc/scan_common.cuh
finish_blocks, at the end of the scan kernels' launches) and of the
standalone combine kernel (csrc/swar_scan.cu), which use the scan kernel's
per-block summaries with the same algebra.
"""

from __future__ import annotations

import torch


class LineCountCombiner:
    """Incremental exact cross-slab line-count merge. `total` is monotone
    non-decreasing after each push — a later slab's boundary dedup only
    subtracts from its OWN contribution — so callers may early-exit (-m,
    krep.c:2950-2962) as soon as total reaches the cap."""

    def __init__(self):
        self.total = 0
        self.open_match = False  # line open at slab start already has a match

    def push(self, c, lead, trail, anym, hasnl) -> int:
        self.total += int(c)
        if self.open_match and bool(lead):
            self.total -= 1  # the boundary-spanning line was already counted
        if bool(hasnl):
            self.open_match = bool(trail)
        else:
            self.open_match = self.open_match or bool(anym)
        return self.total


def _is_word_byte(b: int) -> bool:
    return (
        0x30 <= b <= 0x39 or 0x41 <= b <= 0x5A or 0x61 <= b <= 0x7A or b == 0x5F
    )


def _open_lines(stats: torch.Tensor):
    """For (B, 8) block summaries: whether the line open after each block
    has a match, and whether the line open entering it does (the exclusive
    fold of the summaries' trail and has_nl). The open-line state after
    block b is an OR of the trails since the last block with a newline."""
    trail, has_nl = stats[:, 2] > 0, stats[:, 4] > 0
    idx = torch.arange(stats.shape[0], device=stats.device)
    last_nl = torch.cummax(torch.where(has_nl, idx, -1), 0).values
    trails = torch.cumsum(trail.to(torch.int64), 0)
    before = torch.where(
        last_nl > 0, trails[(last_nl - 1).clamp(min=0)], torch.zeros_like(trails)
    )
    open_end = (trails - before) > 0
    open_in = torch.zeros_like(open_end)
    open_in[1:] = open_end[:-1]
    return open_end, open_in


def combine_block_stats(stats: torch.Tensor) -> torch.Tensor:
    """Fold (B, 8) int32 block summaries [count, first, trail, lead, has_nl,
    0, 0, 0] in order into one (8,) int32 summary of the same layout: the
    total match count, the matched-line count, and the whole run's trail,
    lead and has_nl. Vectorised (see _open_lines)."""
    s = stats.to(torch.int64)
    count, first = s[:, 0], s[:, 1]
    lead, has_nl = s[:, 3] > 0, s[:, 4] > 0
    open_end, open_in = _open_lines(s)
    nl_before = torch.cumsum(has_nl.to(torch.int64), 0) - has_nl.to(torch.int64)
    out = torch.zeros(8, dtype=torch.int32, device=s.device)
    out[0] = (count.sum() + (1 << 31)) % (1 << 32) - (1 << 31)  # wraps, as the kernel's sum
    out[1] = first.sum() - (open_in & lead).sum()
    out[2] = open_end[-1]
    out[3] = (lead & (nl_before == 0)).any()
    out[4] = has_nl.any()
    return out


def first_line_fixup(stats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of the scan tail's first-line fix-up (csrc/scan_common.cuh
    clear_entering_leads): in a u8 first-in-line mask made block by block
    as if each 64 KiB block began on a closed line, clear the lead flag of
    every block (its text offset in stats word 5, -1 if none) whose
    entering line already has a match. Updates `mask` in place and returns
    it."""
    _, open_in = _open_lines(stats)
    lead = stats[:, 5].to(torch.int64)
    mask[lead[open_in & (lead >= 0)]] = 0
    return mask
