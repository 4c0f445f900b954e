"""Multi-pattern count as int8 Hamming products (the K >= 32 route).

Port of krep_tpu/ops/mxu_multi.py in all its modes: the ALL-overlap count
of up to MXU_MAX_PASS patterns of 1..MAX_LEN_LONG NUL-free bytes, and their
union start mask, over freshly staged text (zeros past true_len, so no
bound at the text's end). The sharded route (parallel/mesh.py) adds the
shard mode: `start_limit` drops the starts past a shard's owned bytes, whose
windows read the next shard's real text, and `prev_flag` is the -w flag of
the byte before the shard. `want_lines` (KREP_TPU_MXU_LINES=inkernel,
ops/multi.py) writes per-block line summaries of the union instead of its
mask; `strict` bounds each start by its pattern's length against true_len
and reads no -w flag past it, for a StagedText.with_len view whose bytes
past true_len are live text (and lets members hold NUL bytes).

A match of pattern k at byte 4w+p is a zero Hamming distance over the
window of 16 bytes at word w, which is linear in the text's bits:
D = G @ W with W[(j, b), w] = bit b of byte 4w+j and G[(p, k), (j, b)] =
1 - 2 * pattern bit; a match is D == nb = -(set bits of k). Patterns over
MAX_LEN bytes add a second window over bytes 16..31 (G2) and hit where both
windows do; -w adds boundary features that ride G's extra columns.
`build_tables` is a numpy twin of mxu_multi.build_tables (which wraps its
output in jnp arrays), so both packages use the same tables.

`hamming_scan` launches the CUDA kernel (csrc/hamming_scan.cu, mma.sync
m16n8k32 on the int8 tensor cores) on a CUDA tensor and runs `hamming_scan_plain`, the same
products in float32, on a CPU tensor. `LAUNCHES` counts kernel launches,
`SHARD_LAUNCHES`, `LINES_LAUNCHES` and `STRICT_LAUNCHES` those of them in
the shard, line and strict modes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .literal import (
    BLOCK_BYTES, STAT_WORDS, _fold, _is_word_char, fold_bytes_host, lines_block_stats,
)

MAX_LEN = 13          # p + len <= 16 window bytes: one product
MAX_LEN_LONG = 29     # p + len <= 32: the two-window AND
ROWS = 128            # window bits: 16 bytes x 8
MXU_MIN_K = 32        # the routing threshold of krep_tpu/ops/multi.py
MXU_MAX_PASS = 256    # patterns per pass
PLAIN_CHUNK_WORDS = 1 << 18  # 1 MiB of text per plain product

LAUNCHES = 0
SHARD_LAUNCHES = 0
LINES_LAUNCHES = 0
STRICT_LAUNCHES = 0
NO_LIMIT = 1 << 62    # start_limit of the kernel when there is none

# Kernel operand geometry (csrc/hamming_scan.cu): mma.sync m16n8k32 A
# fragments of 16 rows x 32 feature columns.
_FRAG = 16
_KSTEP = 32
_KCOLS_WORD = 192     # 128 bit rows + 48 boundary rows, padded to six k-steps
_BOUNDARY = 48        # -w feature rows the kernel reads offsets for
_NO_BYTE = -128


def build_tables(patterns: tuple[bytes, ...], case_sensitive: bool,
                 whole_word: bool = False):
    """Host tables of mxu_multi.build_tables, as numpy arrays: (G1, nb1,
    G2, nb2, lens, bitmask, kp_s, qs). G1 (4Kp, 128[+BC]) int8 holds each
    (phase, pattern) row's first window (and, with whole_word, its two
    boundary columns); patterns are reordered shorts-first, so per phase
    kp_s rows of shorts and padding precede the long rows; G2 (4*kp_l,
    rows2) holds the long rows' second window (None for an all-short set).
    Padding rows have nb1 = 1 and never hit. qs: the word shifts of the
    boundary feature rows (() unless whole_word)."""
    pats = [p if case_sensitive else fold_bytes_host(p) for p in patterns]
    pats.sort(key=lambda p: len(p) > MAX_LEN)  # stable: shorts first
    n_short = sum(1 for p in pats if len(p) <= MAX_LEN)
    n_long = len(pats) - n_short
    kp_s = -(-n_short // 8) * 8
    kp_l = -(-n_long // 8) * 8
    Kp = kp_s + kp_l
    nwords2 = 0 if not n_long else -(-(3 + max(len(p) for p in pats) - 16) // 4)
    rows2 = 32 * nwords2
    G1 = np.zeros((4 * Kp, ROWS), np.int8)
    nb1 = np.ones((4 * Kp, 1), np.int32)
    lens = np.full((4 * Kp, 1), 1 << 20, np.int32)
    G2 = np.zeros((4 * kp_l, rows2), np.int8) if n_long else None
    nb2 = np.zeros((4 * kp_l, 1), np.int32) if n_long else None
    for p in range(4):
        for k, pat in enumerate(pats):
            row = k if k < n_short else kp_s + (k - n_short)
            r1 = p * Kp + row
            s = [0, 0]
            for d, byte in enumerate(pat):
                w, j = divmod(p + d, 16)
                for b in range(8):
                    bit = (byte >> b) & 1
                    if w == 0:
                        G1[r1, 8 * j + b] = 1 - 2 * bit
                    else:
                        G2[p * kp_l + (k - n_short), 8 * j + b] = 1 - 2 * bit
                    s[w] += bit
            nb1[r1, 0] = -s[0]
            lens[r1, 0] = len(pat)
            if k >= n_short:
                nb2[p * kp_l + (k - n_short), 0] = -s[1]
    # the TPU kernel's per-W-row bit selects (bit 8*(j%4)+b of a word)
    r = np.arange(ROWS)
    bitmask = (np.uint32(1) << (8 * (r // 8 % 4) + r % 8).astype(np.uint32))[:, None]
    qs = ()
    if whole_word:
        # boundary feature rows: 4 per word shift q touched by a right
        # offset o = p + m (bytes 0..3 of word w+q), then one row for the
        # byte before the window (o = -1); padded to a multiple of 8
        offs = sorted({p + len(pat) for p in range(4) for pat in pats})
        qs = tuple(sorted({0} | {o // 4 for o in offs}))
        neg_col = 4 * len(qs)
        BC = -(-(neg_col + 1) // 8) * 8
        col_of = {4 * q + jj: 4 * qi + jj for qi, q in enumerate(qs) for jj in range(4)}
        G1 = np.concatenate([G1, np.zeros((4 * Kp, BC), np.int8)], axis=1)
        mb = np.zeros((BC, 1), np.uint32)
        for qi in range(len(qs)):
            for jj in range(4):
                mb[4 * qi + jj, 0] = np.uint32(1) << np.uint32(8 * jj)
        mb[neg_col, 0] = 1
        bitmask = np.concatenate([bitmask, mb], axis=0)
        for p in range(4):
            for k, pat in enumerate(pats):
                row = k if k < n_short else kp_s + (k - n_short)
                r1 = p * Kp + row
                G1[r1, ROWS + (neg_col if p == 0 else col_of[p - 1])] = 1
                G1[r1, ROWS + col_of[p + len(pat)]] = 1
    return G1, nb1, G2, nb2, lens, bitmask, kp_s, qs


class HammingTables(NamedTuple):
    """build_tables' output on a device, with the CUDA kernel's operands."""

    g1: torch.Tensor            # (4Kp, 128[+BC]) int8
    nb1: torch.Tensor           # (4Kp,) int32
    g2: torch.Tensor | None     # (4*kp_l, rows2) int8
    nb2: torch.Tensor | None    # (4*kp_l,) int32
    kp_s: int
    qs: tuple
    lens: torch.Tensor          # (4Kp,) int32: each row's pattern length
    # kernel operands (csrc/hamming_scan.cu): rows regrouped into a short
    # and a long section (each a whole number of 16-row tiles, every 8-row
    # group of one phase), as m16n8k32 A fragments in lane order
    g1_frags: torch.Tensor      # (mtiles, KS1, 32, 16) int8, KS1 = 4, or 6 with -w
    g2_frags: torch.Tensor | None  # (mtiles - long_tile0, 4, 32, 16) int8
    rows: torch.Tensor          # (16 * mtiles, 4) int32: nb1, nb2, phase, length
    long_tile0: int
    boundary: bytes | None      # byte offsets of the 48 -w feature rows


def _fragments(m: np.ndarray, cols: int) -> np.ndarray:
    """(R, C) -> (R/16, cols/32, 32, 16): the A fragments of mma.sync
    m16n8k32 (s8, row-major A), the columns zero-padded to `cols`. Lane
    4g + t of fragment (mt, ks) holds, as its four 32-bit registers, row g
    and row g + 8 of the 16-row tile at columns 4t..4t+3, then the same
    rows at columns 16 + 4t..16 + 4t + 3 (PTX ISA, the m16n8k32 fragment
    layout for .s8): one 16-byte load per lane."""
    r = m.shape[0]
    out = np.zeros((r, cols), np.int8)
    out[:, : m.shape[1]] = m
    # (mt, hi, g, ks, q, t, i) -> (mt, ks, g, t, q, hi, i)
    t = out.reshape(r // _FRAG, 2, 8, cols // _KSTEP, 2, 4, 4).transpose(0, 3, 2, 5, 4, 1, 6)
    return np.ascontiguousarray(t.reshape(r // _FRAG, cols // _KSTEP, 32, 16))


def device_tables(tables, device) -> HammingTables:
    """build_tables' output (numpy) as the port's tensors on `device`."""
    G1, nb1, G2, nb2, lens, _bitmask, kp_s, qs = tables
    Kp = G1.shape[0] // 4
    kp_l = Kp - kp_s
    short = [p * Kp + i for p in range(4) for i in range(kp_s)]
    long_ = [p * Kp + i for p in range(4) for i in range(kp_s, Kp)]
    S = -(-len(short) // _FRAG) * _FRAG
    L = -(-len(long_) // _FRAG) * _FRAG
    order = np.array(short + [-1] * (S - len(short)) + long_ + [-1] * (L - len(long_)))
    real = order >= 0
    g1k = np.zeros((S + L, G1.shape[1]), np.int8)
    g1k[real] = G1[order[real]]
    rows = np.zeros((S + L, 4), np.int32)
    rows[:, 0] = 1  # padding never hits
    rows[real, 0] = nb1[order[real], 0]
    rows[real, 2] = order[real] // Kp
    rows[real, 3] = lens[order[real], 0]
    # the kernel reads one phase per 8-row group (kp_s and kp_l are multiples of 8)
    assert (rows[:, 2].reshape(-1, 8) == rows[::8, 2:3]).all()
    g2_frags = None
    if G2 is not None:
        g2k = np.zeros((L, G2.shape[1]), np.int8)
        i2 = [p * kp_l + i for p in range(4) for i in range(kp_l)]
        g2k[: len(i2)] = G2[i2]
        rows[S : S + len(i2), 1] = nb2[i2, 0]
        g2_frags = _fragments(g2k, ROWS)
    boundary = None
    if qs:
        off = np.full(_BOUNDARY, _NO_BYTE, np.int8)
        for qi, q in enumerate(qs):
            off[4 * qi : 4 * qi + 4] = 4 * q + np.arange(4)
        off[4 * len(qs)] = -1
        boundary = off.tobytes()

    def put(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(device)

    return HammingTables(
        g1=put(G1), nb1=put(nb1[:, 0]), g2=put(G2),
        nb2=None if nb2 is None else put(nb2[:, 0]), kp_s=kp_s, qs=tuple(qs),
        lens=put(lens[:, 0]),
        g1_frags=put(_fragments(g1k, _KCOLS_WORD if qs else ROWS)),
        g2_frags=put(g2_frags), rows=put(rows), long_tile0=S // _FRAG, boundary=boundary,
    )


def _window_bits(t: torch.Tensor, words: torch.Tensor, j0: int, nj: int) -> torch.Tensor:
    """(8 nj, len(words)) float32: row 8j+b = bit b of byte 4w + j0 + j."""
    idx = 4 * words[None, :] + torch.arange(j0, j0 + nj, device=t.device)[:, None]
    shifts = torch.arange(8, dtype=torch.uint8, device=t.device)
    bits = (t[idx][:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(8 * nj, -1).to(torch.float32)


def _check_modes(want_mask, want_lines, strict, true_len, start_limit):
    if want_lines and (want_mask or strict or start_limit is not None):
        raise ValueError("want_lines takes no mask, strict or start_limit")
    if strict and (true_len is None or true_len < 0):
        raise ValueError("strict needs a true_len >= 0")
    if start_limit is not None and start_limit < 0:
        raise ValueError("start_limit must not be negative")


def hamming_scan_plain(
    text: torch.Tensor, n_blocks: int, tables: HammingTables, *,
    case_sensitive: bool = True, want_mask: bool = False,
    start_limit: int | None = None, prev_flag: int = 0,
    want_lines: bool = False, strict: bool = False, true_len: int | None = None,
):
    """Plain twin of the Hamming kernel: per-64 KiB-block match counts
    (n_blocks,) int32 and the u8 0/1 union start mask over the body (None
    unless want_mask), from the same products D = G @ W in float32 (with
    the -w boundary features when the tables have them), in
    chunks of PLAIN_CHUNK_WORDS words. Only starts below `start_limit`
    count; `prev_flag` is the -w flag of the byte before the text. With
    `strict`, a start of a pattern of length m counts only where
    start + m <= `true_len`, and the -w features read no word flag at or
    past true_len. With `want_lines`, returns (stats, None): the (n_blocks,
    8) int32 summaries of literal.lines_block_stats over the union mask,
    word 0 replaced by the block counts. Every W and G entry is 0 or +-1
    and |D| <= 176, so float32 — and TF32 as well — is exact; TF32 is
    turned off on the card anyway, so exactness never rests on that
    bound."""
    _check_modes(want_mask, want_lines, strict, true_len, start_limit)
    if text.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = text.device
    body = n_blocks * BLOCK_BYTES
    t = text if case_sensitive else _fold(text)
    g1 = tables.g1.to(torch.float32)
    nb1 = tables.nb1.to(torch.float32)[:, None]
    Kp = g1.shape[0] // 4
    kp_s = tables.kp_s
    two = tables.g2 is not None
    if two:
        g2 = tables.g2.to(torch.float32)
        nb2 = tables.nb2.to(torch.float32)[:, None]
        kp_l = Kp - kp_s
    if tables.qs:
        is_w = _is_word_char(t)
        if strict:
            is_w[true_len:] = False
    if strict:  # the last start of each row
        last = true_len - tables.lens.to(torch.int64).view(4, Kp, 1)
    per_word = torch.empty(body // 4, dtype=torch.int32, device=dev)
    need_mask = want_mask or want_lines
    mask = torch.zeros(body, dtype=torch.uint8, device=dev) if need_mask else None
    for w0 in range(0, body // 4, PLAIN_CHUNK_WORDS):
        words = torch.arange(w0, min(body // 4, w0 + PLAIN_CHUNK_WORDS), device=dev)
        feats = [_window_bits(t, words, 0, 16)]
        if tables.qs:  # -w boundary features
            for q in tables.qs:
                idx = 4 * (words[None, :] + q) + torch.arange(4, device=dev)[:, None]
                feats.append(is_w[idx].to(torch.float32))
            before = torch.where(words > 0, is_w[(4 * words - 1).clamp(min=0)], bool(prev_flag))
            feats.append(before.to(torch.float32)[None, :])
            pad = g1.shape[1] - sum(f.shape[0] for f in feats)
            feats.append(torch.zeros((pad, words.shape[0]), device=dev))
        hits = (g1 @ torch.cat(feats)) == nb1                      # (4Kp, nw)
        if two:
            hits2 = (g2 @ _window_bits(t, words, 16, g2.shape[1] // 8)) == nb2
            for p in range(4):
                hits[p * Kp + kp_s : (p + 1) * Kp] &= hits2[p * kp_l : (p + 1) * kp_l]
        # row p * Kp + k starts at byte 4w + p
        starts = 4 * words[None, :] + torch.arange(4, device=dev)[:, None]
        if start_limit is not None:
            hits = (hits.view(4, Kp, -1) & (starts < start_limit)[:, None, :]).view(4 * Kp, -1)
        if strict:  # only the words whose windows may reach true_len
            lo = max(0, min(words.shape[0], (true_len - 32) // 4 - w0))
            hits.view(4, Kp, -1)[:, :, lo:] &= starts[:, None, lo:] <= last
        per_word[words[0] : words[-1] + 1] = hits.sum(0, dtype=torch.int32)
        if need_mask:
            anyp = hits.view(4, Kp, -1).any(1)                     # (4, nw)
            mask.view(-1, 4)[words[0] : words[-1] + 1] = anyp.T.to(torch.uint8)
    counts = per_word.view(n_blocks, BLOCK_BYTES // 4).sum(1, dtype=torch.int32)
    if want_lines:
        stats = lines_block_stats(text, mask, n_blocks)
        stats[:, 0] = counts
        return stats, None
    return counts, mask


def hamming_scan(
    text: torch.Tensor, n_blocks: int, tables: HammingTables, *,
    case_sensitive: bool = True, want_mask: bool = False,
    start_limit: int | None = None, prev_flag: int = 0,
    want_lines: bool = False, strict: bool = False, true_len: int | None = None,
):
    """Per-64 KiB-block match counts (n_blocks,) int32 and the u8 0/1 union
    start mask (None unless want_mask) of the tables' patterns over the
    first n_blocks * 64 KiB bytes of staged `text` (flat uint8, zero past
    true_len, holding 64 more bytes: the staged halo). -w is whatever the
    tables were built for; `case_sensitive` must match them too. With a
    `start_limit` (the shard mode) only starts below it count, and the
    bytes past it may be real text; `prev_flag` is the -w flag of the byte
    before the text. `strict` (with `true_len`) bounds each start by its
    pattern's length against true_len, for text whose bytes past true_len
    are live. `want_lines` (no mask, strict or start_limit) returns
    (stats, None) instead: (n_blocks, 8) int32 [count, first, trail, lead,
    has_nl, 0, 0, 0] of the union, which swar.combine_blocks folds."""
    from . import swar

    body = swar._check_text(text, n_blocks, swar.TAIL_BYTES)
    _check_modes(want_mask, want_lines, strict, true_len, start_limit)
    kw = dict(case_sensitive=case_sensitive, want_mask=want_mask, start_limit=start_limit,
              prev_flag=prev_flag, want_lines=want_lines, strict=strict, true_len=true_len)
    if swar._device_kind(text) == "cpu":
        return hamming_scan_plain(text, n_blocks, tables, **kw)

    from . import _build

    swar._check_cuda(text, torch.uint8, "text")
    shape = (n_blocks, STAT_WORDS) if want_lines else (n_blocks,)
    out = torch.empty(shape, dtype=torch.int32, device=text.device)
    mask = torch.empty(body, dtype=torch.uint8, device=text.device) if want_mask else None
    mode = 1 if want_lines else 2 if strict else 0  # csrc/hamming_scan.cu's Mode
    stream = torch.cuda.current_stream(text.device).cuda_stream
    with torch.cuda.device(text.device):
        err = _build.library().krep_hamming_scan(
            text.data_ptr(), n_blocks, tables.g1_frags.data_ptr(),
            None if tables.g2_frags is None else tables.g2_frags.data_ptr(),
            tables.rows.data_ptr(), tables.g1_frags.shape[0], tables.long_tile0,
            tables.boundary, int(not case_sensitive),
            NO_LIMIT if start_limit is None else int(start_limit), int(bool(prev_flag)),
            int(true_len) if strict else 0, mode,
            None if mask is None else mask.data_ptr(), out.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"hamming_scan kernel launch failed: CUDA error {err}")
    global LAUNCHES, SHARD_LAUNCHES, LINES_LAUNCHES, STRICT_LAUNCHES
    LAUNCHES += 1
    SHARD_LAUNCHES += start_limit is not None
    LINES_LAUNCHES += want_lines
    STRICT_LAUNCHES += strict
    return out, mask


def scan_count(staged, *, patterns: tuple[bytes, ...], case_sensitive: bool = True,
               whole_word: bool = False, want_mask: bool = False,
               start_limit: int | None = None, prev_flag: int = 0,
               strict: bool = False, want_lines: bool = False):
    """ALL-overlap count of 1..MXU_MAX_PASS patterns over a staged text
    (dispatch.StagedText). Returns device tensors (total, mask,
    group_counts): the int64 total, the u8 0/1 union start mask (None
    unless want_mask) and the per-64 KiB counts; with want_lines, the
    matched-line count of the union (int32) in place of the mask.
    Members must be 1..MAX_LEN_LONG bytes. Without `strict` they must be
    NUL-free and the text freshly staged: with zeros past true_len, a
    window that crosses it can then never match, so no bound at the text's
    end is needed. `strict` bounds every start against staged.true_len
    instead, for a with_len view, and takes NUL members as well.
    `start_limit` and `prev_flag` as for hamming_scan (the arguments of
    mxu_multi.scan_count)."""
    if not 1 <= len(patterns) <= MXU_MAX_PASS or any(
        not 0 < len(p) <= MAX_LEN_LONG or (0 in p and not strict) for p in patterns
    ):
        raise ValueError("pattern set outside the Hamming kernel's support")
    tables = device_tables(build_tables(patterns, case_sensitive, whole_word), staged.u8.device)
    out, mask = hamming_scan(
        staged.u8, staged.n_blocks, tables, case_sensitive=case_sensitive,
        want_mask=want_mask, start_limit=start_limit, prev_flag=prev_flag,
        want_lines=want_lines, strict=strict, true_len=staged.true_len if strict else None,
    )
    if want_lines:
        from .swar import combine_blocks

        return out[:, 0].sum(), combine_blocks(out)[1], out[:, 0]
    return out.sum(), mask, out
