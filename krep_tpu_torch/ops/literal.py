"""Single-pattern literal scan: the plain PyTorch versions.

Port of krep_tpu/ops/literal.py. `all_starts_mask` is the dense all-starts
match mask (M[i] iff text[i:i+m] == pattern, after the optional ASCII fold,
optionally filtered by whole-word boundaries); the line functions count
distinct matched lines the way the reference's -c dedup does
(krep.c:1331-1351). `block_stats`, `block_stats_multi` and
`lines_block_stats` are the plain twins of the CUDA scan kernels
(csrc/swar_scan.cu, multi_scan.cu, lines_scan.cu): the same per-64 KiB
summaries, and the same start or first-in-line masks.

These run wherever their tensors live. The CPU path uses them, and on the
card they are the reference the CUDA kernels are held against. Offsets
are int32 inside one array: staged arrays stay below 2 GiB.
"""

from __future__ import annotations

import torch

NEWLINE = 10
BLOCK_BYTES = 65536  # text bytes per CUDA block, and per summary row
STAT_WORDS = 8       # count, first, trail, lead, has_nl, 0, 0, 0
PREFIX_PASSES = 8    # all_starts_mask compares this many pattern bytes at every start
VERIFY_BYTES = 1 << 22  # ... and the rest at the surviving starts, this many bytes a chunk


def fold_bytes_host(b: bytes) -> bytes:
    """ASCII lower-fold, matching the reference's C-locale lower_table
    (krep.c:124-134)."""
    return bytes(c + 32 if 0x41 <= c <= 0x5A else c for c in b)


def _fold(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x >= 0x41) & (x <= 0x5A), x + 32, x)


def _is_word_char(x: torch.Tensor) -> torch.Tensor:
    """alnum or '_' — mirror of is_word_char (krep.h:298-305)."""
    return (
        ((x >= 0x30) & (x <= 0x39))
        | ((x >= 0x41) & (x <= 0x5A))
        | ((x >= 0x61) & (x <= 0x7A))
        | (x == 0x5F)
    )


def all_starts_mask(
    text: torch.Tensor,
    pattern: bytes,
    *,
    case_sensitive: bool = True,
    whole_word: bool = False,
    true_len: int | None = None,
    prev_word: int = 0,
    start_limit: int | None = None,
) -> torch.Tensor:
    """Dense all-starts bool mask over a uint8 text tensor.

    `text` may be padded; `true_len` is the real byte count (defaults to the
    tensor's length): starts beyond true_len - m are masked off, and the
    -w after-byte is read from the tensor even past true_len. `start_limit`
    bounds starts to an owned region; `prev_word` is the is-word flag of
    the byte before position 0."""
    n = text.shape[0]
    m = len(pattern)
    if true_len is None:
        true_len = n
    acc = torch.zeros(n, dtype=torch.bool, device=text.device)
    lim = min(n, true_len - m + 1)
    if start_limit is not None:
        lim = min(lim, start_limit)
    if m == 0 or lim <= 0:
        return acc

    pat = pattern if case_sensitive else fold_bytes_host(pattern)
    t = text if case_sensitive else _fold(text)
    # starts < lim need bytes up to lim + m - 1 <= true_len <= n
    acc[:lim] = t[:lim] == pat[0]
    for j in range(1, min(m, PREFIX_PASSES)):
        acc[:lim] &= t[j : lim + j] == pat[j]
    if m > PREFIX_PASSES:
        # the rest of a long pattern at the surviving starts only, in chunks
        # of about VERIFY_BYTES compared bytes
        cand = torch.nonzero(acc[:lim]).squeeze(1)
        rest = torch.tensor(list(pat[PREFIX_PASSES:]), dtype=torch.uint8, device=text.device)
        offs = torch.arange(PREFIX_PASSES, m, device=text.device)
        step = max(1, VERIFY_BYTES // m)
        for c0 in range(0, cand.shape[0], step):
            c = cand[c0 : c0 + step]
            acc[c[~(t[c[:, None] + offs] == rest).all(1)]] = False

    if whole_word:
        # is_whole_word_match (krep.h:307-319): the bytes before the start
        # and after the end must be non-word (text edges count as bounds)
        w = _is_word_char(t)
        before = torch.empty(lim, dtype=torch.bool, device=text.device)
        before[0] = bool(prev_word)
        before[1:] = w[: lim - 1]
        after = torch.zeros(lim, dtype=torch.bool, device=text.device)
        hi = min(lim, n - m)  # starts whose after-byte lies in the tensor
        if hi > 0:
            after[:hi] = w[m : m + hi]
        acc[:lim] &= ~before & ~after
    return acc


def _line_ids(mask: torch.Tensor, nl: torch.Tensor):
    """Match positions and, for each, the number of newlines strictly
    before it (its line id). A match on a '\\n' byte belongs to the line
    that '\\n' ends (find_line_start, krep.c:363-386)."""
    pos = torch.nonzero(mask).squeeze(1)
    seen = _newlines_through(nl)
    return pos, seen[pos] - nl[pos].to(torch.int32), seen


SCAN_CHUNK = 1 << 28


def _newlines_through(nl: torch.Tensor) -> torch.Tensor:
    """int32 count of newlines at or before each position, scanned in
    chunks of SCAN_CHUNK elements: one CUDA torch.cumsum over the 1.5 Gi
    elements of a 1 GiB slab's bucket faults with an illegal address
    (torch 2.11, CUDA 12.8, H100), while 1 Gi elements pass."""
    seen = torch.empty(nl.shape[0], dtype=torch.int32, device=nl.device)
    for lo in range(0, nl.shape[0], SCAN_CHUNK):
        part = seen[lo : lo + SCAN_CHUNK]
        torch.cumsum(nl[lo : lo + SCAN_CHUNK], 0, dtype=torch.int32, out=part)
        if lo:
            part += seen[lo - 1].clone()
    return seen


def _first_flags(lid: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(lid, dtype=torch.bool)
    first[1:] = lid[1:] != lid[:-1]
    return first


def first_in_line_mask(mask: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """Bool mask of matches that are the FIRST match in their line — the
    "-c" dedup event (find_line_start dedup, krep.c:1331-1351)."""
    return _first_in_line(mask, text == NEWLINE)


def _first_in_line(mask: torch.Tensor, nl: torch.Tensor) -> torch.Tensor:
    pos, lid, _ = _line_ids(mask, nl)
    out = torch.zeros_like(mask)
    out[pos[_first_flags(lid)]] = True
    return out


def matched_line_count(mask: torch.Tensor, text: torch.Tensor) -> int:
    """Number of distinct lines containing ≥1 match start."""
    _, lid, _ = _line_ids(mask, text == NEWLINE)
    return int(_first_flags(lid).sum())


def shard_line_stats(mask: torch.Tensor, text: torch.Tensor):
    """Per-shard line-accounting stats for exact cross-shard merging.

    Returns (local_first_in_line_count, lead, trail, any_match, has_nl):
      lead  — ≥1 match in the leading segment (before the first \\n, or on it)
      trail — ≥1 match strictly after the last \\n
    parallel/lines.py merges them (LineCountCombiner)."""
    nl = text == NEWLINE
    pos, lid, seen = _line_ids(mask, nl)
    count = int(_first_flags(lid).sum())
    any_match = pos.numel() > 0
    n_nl = int(seen[-1]) if seen.numel() else 0
    lead = any_match and int(lid[0]) == 0
    trail = any_match and int(lid[-1]) == n_nl
    return count, lead, trail, any_match, n_nl > 0


def scan_literal(
    text: torch.Tensor,
    true_len: int,
    *,
    pattern: bytes,
    case_sensitive: bool = True,
    whole_word: bool = False,
    want_mask: bool = True,
    mask_kind: str = "starts",
):
    """One fused scan: returns (match_count, matched_line_count, mask_u8).

    mask_u8 is one byte per text position; a (128,) zero placeholder when
    want_mask=False. mask_kind: "starts" flags every match start;
    "first_line" flags only first-in-line matches (the -c dedup events)."""
    mask = all_starts_mask(
        text, pattern,
        case_sensitive=case_sensitive, whole_word=whole_word, true_len=true_len,
    )
    count = int(mask.sum())
    fil = first_in_line_mask(mask, text)
    lines = int(fil.sum())
    if want_mask:
        out_mask = (fil if mask_kind == "first_line" else mask).to(torch.uint8)
    else:
        out_mask = torch.zeros(128, dtype=torch.uint8, device=text.device)
    return count, lines, out_mask


def scan_shard(
    text: torch.Tensor,
    true_len: int,
    prev_word: int,
    start_limit: int,
    *,
    pattern: bytes,
    case_sensitive: bool = True,
    whole_word: bool = False,
    want_mask: bool = False,
):
    """Per-slab scan with the contract of krep_tpu's scan_shard_host
    (ops/literal.py:176) and pallas_swar.scan_shard: match STARTS and
    newline accounting are bounded to [0, start_limit) — the owned region
    — while matches may extend into the halo up to true_len; prev_word is
    the is-word flag of the byte before the slab.

    Returns (count, first_in_line, trail, lead, has_nl, mask_u8)."""
    n = text.shape[0]
    mask = all_starts_mask(
        text, pattern,
        case_sensitive=case_sensitive, whole_word=whole_word,
        true_len=true_len, prev_word=prev_word, start_limit=start_limit,
    )
    owned = text[: max(0, min(start_limit, n))]
    fcount, lead, trail, _, has_nl = shard_line_stats(mask[: owned.shape[0]], owned)
    count = int(mask.sum())
    out_mask = (
        mask.to(torch.uint8) if want_mask
        else torch.zeros(128, dtype=torch.uint8, device=text.device)
    )
    return count, fcount, trail, lead, has_nl, out_mask


def _block_summaries(
    mask: torch.Tensor, nl: torch.Tensor, n_blocks: int, lead_offsets: bool = False
) -> torch.Tensor:
    """(n_blocks, 8) int32 [set mask bytes, first, trail, lead, has_nl,
    0, 0, 0] of a bool start mask and newline flags over n_blocks * 64 KiB,
    each block summarised as if it began on a closed line (see
    parallel/lines.py). With lead_offsets, word 5 is the offset of the
    block's lead match (its first, when lead is set), else -1."""
    dev = mask.device
    stats = torch.zeros((n_blocks, STAT_WORDS), dtype=torch.int32, device=dev)
    if lead_offsets:
        stats[:, 5] = -1
    stats[:, 0] = mask.view(n_blocks, BLOCK_BYTES).sum(1, dtype=torch.int32)
    stats[:, 4] = nl.view(n_blocks, BLOCK_BYTES).any(1).to(torch.int32)

    pos, lid, seen = _line_ids(mask, nl)
    if pos.numel():
        blk = pos // BLOCK_BYTES
        new_blk = torch.ones_like(blk, dtype=torch.bool)
        new_blk[1:] = blk[1:] != blk[:-1]
        last_of_blk = torch.ones_like(blk, dtype=torch.bool)
        last_of_blk[:-1] = blk[1:] != blk[:-1]
        first = _first_flags(lid) | new_blk
        stats[:, 1].index_add_(0, blk, first.to(torch.int32))

        starts = torch.arange(n_blocks, device=dev) * BLOCK_BYTES
        nl_before = seen[starts] - nl[starts].to(torch.int32)  # before each block
        nl_through = seen[starts + BLOCK_BYTES - 1]            # through each block's end
        b0 = blk[new_blk]
        lead = lid[new_blk] == nl_before[b0]
        stats[b0, 3] = lead.to(torch.int32)
        if lead_offsets:
            stats[b0[lead], 5] = pos[new_blk][lead].to(torch.int32)
        b1 = blk[last_of_blk]
        stats[b1, 2] = (lid[last_of_blk] == nl_through[b1]).to(torch.int32)
    return stats


def block_stats(
    text: torch.Tensor,
    true_len: int,
    n_blocks: int,
    *,
    pattern: bytes,
    case_sensitive: bool = True,
    whole_word: bool = False,
    prev_word: int = 0,
    start_limit: int | None = None,
    want_mask: bool = False,
    mask_kind: str = "starts",
):
    """Plain twin of the CUDA scan kernel (and, for mask_kind="first_line",
    of its in-launch first-line fix-up): per-64 KiB-block summaries (n_blocks, 8)
    int32 of [count, first, trail, lead, has_nl, 0, 0, 0], each computed as
    if its block began on a closed line (see parallel/lines.py), and the u8
    mask over the n_blocks * 64 KiB body (None unless want_mask): every
    match start, or for "first_line" the matches that are the first of
    their line (a line ends at a newline below start_limit); word 5 is then
    the text offset of each block's lead match, -1 if none. `text` must
    reach past the body by the pattern length, as staged text does through
    its zero halo."""
    if mask_kind not in ("starts", "first_line"):
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    first_line = mask_kind == "first_line"
    if first_line and not want_mask:
        raise ValueError('mask_kind="first_line" needs want_mask')
    body = n_blocks * BLOCK_BYTES
    mask = all_starts_mask(
        text, pattern,
        case_sensitive=case_sensitive, whole_word=whole_word,
        true_len=true_len, prev_word=prev_word, start_limit=start_limit,
    )[:body]
    nl = text[:body] == NEWLINE
    if start_limit is not None:
        nl[max(0, start_limit):] = False
    stats = _block_summaries(mask, nl, n_blocks, lead_offsets=first_line)
    if first_line:
        mask = _first_in_line(mask, nl)
    return stats, (mask.to(torch.uint8) if want_mask else None)


def block_stats_multi(
    text: torch.Tensor,
    true_len: int,
    n_blocks: int,
    *,
    patterns: tuple[bytes, ...],
    case_sensitive: bool = True,
    whole_word: bool = False,
    prev_word: int = 0,
    start_limit: int | None = None,
    want_mask: bool = False,
):
    """Plain twin of the K-pattern CUDA scan kernel: the OR and the sum of
    the patterns' all-starts masks cut into block summaries. Returns
    (n_blocks, 8) int32 [matches, first, trail, lead, has_nl, 0, 0, 0] —
    matches summed over the patterns, the line fields of the union — and
    the u8 union start mask (None unless want_mask). The shard mode of
    pallas_swar.scan_shard_multi: `start_limit` bounds every pattern's
    starts, and the newlines that count, to [0, start_limit) (each match
    still ends by true_len); `prev_word` is the -w flag of the byte before
    the text."""
    body = n_blocks * BLOCK_BYTES
    union = torch.zeros(body, dtype=torch.bool, device=text.device)
    counts = torch.zeros(n_blocks, dtype=torch.int32, device=text.device)
    for p in patterns:
        m = all_starts_mask(
            text, p, case_sensitive=case_sensitive, whole_word=whole_word,
            true_len=true_len, prev_word=prev_word, start_limit=start_limit,
        )[:body]
        union |= m
        counts += m.view(n_blocks, BLOCK_BYTES).sum(1, dtype=torch.int32)
    nl = text[:body] == NEWLINE
    if start_limit is not None:
        nl[max(0, start_limit):] = False
    stats = _block_summaries(union, nl, n_blocks)
    stats[:, 0] = counts
    return stats, (union.to(torch.uint8) if want_mask else None)


def lines_block_stats(text: torch.Tensor, mask: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Plain twin of the CUDA lines kernel: block summaries (n_blocks, 8)
    int32 [set mask bytes, first, trail, lead, has_nl, 0, 0, 0] of a u8
    0/1 start mask over the text's first n_blocks * 64 KiB. A flag on a
    '\n' byte counts the line that '\n' ends, which is pallas_swar's
    `nl_start_matches` rule whichever way that switch is set."""
    body = n_blocks * BLOCK_BYTES
    return _block_summaries(mask[:body] != 0, text[:body] == NEWLINE, n_blocks)
