"""The word scan of csrc/swar_scan.cu and csrc/byte_scan.cu, step by step.

`word_scan_emulation` is a numpy model of the kernel's own steps
(scan_common.cuh `word_scan_block`): each warp's 8 KiB in strides of 512
bytes, lane l holding bytes 16l..16l+15 as four little-endian words; the
next lane's first words taken by the shuffle (lane 31 from lane 0's
next-stride load), the -w before-byte flag from the previous lane (lane 0
from lane 31 of the previous stride); the funnel-shifted window compares
under byte masks, the 8-byte filter and the compacted verify of longer
patterns; the hit and newline bit words, the state entering each lane from
the warp's ballots and the carry of one add; the lane -> warp -> block
fold; the first_line flags, the warp and block lead flags and the clears.
It is held exactly to the plain versions (literal.block_stats,
bytescan.block_stats_bytes, bytescan.variant_stats_plain, with
lines.first_line_fixup finishing a first_line mask) and, in a few cases, to
interpret-mode pallas_swar.scan_literal / scan_shard and
pallas_scan.scan_literal. The texts are two blocks with matches across
lane (16 B), stride (512 B), warp (8 KiB) and block edges, at true_len - m
and after "_^".
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import naive
from krep_tpu.ops import dispatch as jdispatch
from krep_tpu.ops import pallas_scan, pallas_swar
from krep_tpu_torch import convert
from krep_tpu_torch.ops import bytescan, dispatch, literal, swar
from krep_tpu_torch.parallel import lines

CPU = torch.device("cpu")
BLOCK = literal.BLOCK_BYTES
STRIDE, WARP_BYTES, STRIDES, WARPS = 512, 8192, 16, 8
M32 = np.uint64(0xFFFFFFFF)
LANE = np.arange(32, dtype=np.uint64)


def u64(x):
    return np.asarray(x, dtype=np.uint64)


def funnel(lo, hi, sh: int):
    """__funnelshift_r(lo, hi, sh): the low word of (hi:lo) >> sh."""
    return ((u64(hi) << np.uint64(32) | u64(lo)) >> np.uint64(sh)) & M32


def fold4(x):
    """scan_common.cuh fold4: the ASCII lower-fold of 4 bytes at once."""
    x = u64(x)
    hb = x & np.uint64(0x80808080)
    a = x & np.uint64(0x7F7F7F7F)
    ge_a = (a + np.uint64(0x3F3F3F3F)) & np.uint64(0x80808080)
    gt_z = (a + np.uint64(0x25252525)) & np.uint64(0x80808080)
    upper = ge_a & ~gt_z & ~hb
    return (x + (upper >> np.uint64(2))) & M32


def word_bits4(x):
    """scan_common.cuh word_bits4: the is_word flags of 4 bytes as bits 0..3."""
    x = u64(x)
    a = x & np.uint64(0x7F7F7F7F)
    digit = (a + np.uint64(0x50505050)) & ~(a + np.uint64(0x46464646))
    low = a | np.uint64(0x20202020)
    alpha = (low + np.uint64(0x1F1F1F1F)) & ~(low + np.uint64(0x05050505))
    under = ~((a ^ np.uint64(0x5F5F5F5F)) + np.uint64(0x7F7F7F7F))
    f = (digit | alpha | under) & ~x & np.uint64(0x80808080)
    return (((f >> np.uint64(7)) * np.uint64(0x01020408)) & M32) >> np.uint64(24)


def word_bits16(v):
    """scan_common.cuh word_bits16: the word flags of a lane's 4 words."""
    return (word_bits4(v[..., 0]) | word_bits4(v[..., 1]) << np.uint64(4) |
            word_bits4(v[..., 2]) << np.uint64(8) | word_bits4(v[..., 3]) << np.uint64(12))


def newline_bits4(x):
    """scan_common.cuh newline_bits4: the '\\n' flags of 4 bytes as bits 0..3."""
    b = (u64(x)[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)
    return ((b == 10).astype(np.uint64) << np.arange(4, dtype=np.uint64)).sum(-1, dtype=np.uint64)


def low_bits16(r):
    r = np.asarray(r, np.int64)
    return np.where(r >= 16, 0xFFFF, np.where(r <= 0, 0, (np.int64(1) << np.clip(r, 0, 15)) - 1)
                    ).astype(np.uint64)


def ballot(pred):
    """__ballot_sync over the lane axis (last) of a bool array."""
    return (pred.astype(np.uint64) << LANE).sum(-1, dtype=np.uint64)


def top_bit(d):
    """31 - __clz(d) for d != 0 (exact: d < 2**32)."""
    return np.floor(np.log2(np.maximum(d, 1).astype(np.float64))).astype(np.uint64)


def popc16(x):
    b = np.unpackbits(np.ascontiguousarray(u64(x).astype("<u2")).view(np.uint8))
    return b.reshape(*np.shape(x), 16).sum(-1, dtype=np.int64)


def ffs16(x):
    """__ffs - 1 of a nonzero 16-bit word."""
    x = int(x)
    return (x & -x).bit_length() - 1


def pattern_words(pat: bytes, n: int) -> np.ndarray:
    buf = np.zeros(4 * n, np.uint8)
    buf[: len(pat)] = np.frombuffer(pat, np.uint8)
    return buf.view("<u4").astype(np.uint64)


def verify_rest(fw, text, g, pw, m, wword, before0):
    """verify_long's per-candidate test (verify_rest) for global offsets g:
    bytes 8..m-1 as funnel-shifted aligned words, none read past the word
    of byte g + m - 1, then the -w bytes."""
    a = g + 8
    w0, last, sh = a >> 2, (g + m - 1) >> 2, 8 * (a & 3)
    nw = (m - 8 + 3) // 4
    idx = np.minimum(w0[:, None] + 1 + np.arange(nw)[None, :], last[:, None])
    his = fw[idx]
    los = np.concatenate([fw[w0][:, None], his[:, :-1]], axis=1)
    x = ((his << np.uint64(32) | los) >> u64(sh)[:, None]) & M32
    x ^= pw[2 : 2 + nw][None, :]
    rem = m - 8 - 4 * np.arange(nw)
    keep = np.where(rem >= 4, 0xFFFFFFFF, (1 << (8 * np.clip(rem, 0, 3))) - 1).astype(np.uint64)
    ok = ((x & keep[None, :]) == 0).all(1)
    if wword:
        is_w = np.vectorize(naive.is_word_char, otypes=[bool])
        before = np.where(g == 0, bool(before0), is_w(text[np.maximum(g - 1, 0)]))
        ok &= ~before & ~is_w(text[g + m])
    return ok


class WarpLines:
    """scan_common.cuh WarpLines and fold_lines16 over arrays shaped
    (block, warp, lane): each warp's first-in-line count (per lane), open
    line flag, has_nl, lead, whether it has met no match and no newline
    yet, and the block offset of its lead flag."""

    def __init__(self, n_blocks: int):
        self.first = np.zeros((n_blocks, WARPS, 32), np.int64)
        self.state = np.zeros((n_blocks, WARPS), np.uint64)
        self.has_nl = np.zeros((n_blocks, WARPS), bool)
        self.lead = np.zeros((n_blocks, WARPS), bool)
        self.lead_open = np.ones((n_blocks, WARPS), bool)
        self.lead_off = np.full((n_blocks, WARPS), -1, np.int64)

    def fold(self, hits, nl, so):
        """One stride: the lanes' 16-bit hit and newline words; so (1, WARPS)
        the stride's block offsets. Returns the first-in-line flags."""
        gen, prop = hits & ~nl, ~nl & np.uint64(0xFFFF)
        s0 = gen + prop
        T, N = ballot((s0 >> np.uint64(16)) != 0), ballot(nl != 0)
        D = (T | N)[..., None] & ((np.uint64(1) << LANE) - np.uint64(1))
        enter = np.where(D != 0, (T[..., None] >> top_bit(D)) & np.uint64(1),
                         self.state[..., None])
        open_ = ((s0 + enter) ^ gen ^ prop)
        fst = hits & ~open_ & np.uint64(0xFFFF)
        self.first += popc16(fst)
        upto = np.where(nl != 0, nl ^ (nl - np.uint64(1)), np.uint64(0xFFFF))
        L = ballot((hits & upto) != 0) & np.where(N != 0, N ^ (N - np.uint64(1)), M32)
        found = self.lead_open & (L != 0)
        for b_, w_ in zip(*np.nonzero(found)):
            lb = int(L[b_, w_])
            ll = (lb & -lb).bit_length() - 1
            self.lead_off[b_, w_] = int(so[0, w_]) + 16 * ll + ffs16(hits[b_, w_, ll])
        self.lead |= found
        self.lead_open &= (L == 0) & (N == 0)
        DA = T | N
        self.state = np.where(DA != 0, (T >> top_bit(DA)) & np.uint64(1), self.state)
        self.has_nl |= N != 0
        return fst

    def warp_sums(self, count):
        """put_warp_summary: each block's warp summaries (count, first,
        trail, lead, has_nl), count and first summed over the lanes."""
        return [[(int(count[b, w].sum()), int(self.first[b, w].sum()), int(self.state[b, w]),
                  int(self.lead[b, w]), int(self.has_nl[b, w])) for w in range(WARPS)]
                for b in range(count.shape[0])]


def combine(x, y):
    """scan_common.cuh combine of two (count, first, trail, lead, has_nl)."""
    return (x[0] + y[0], x[1] + y[1] - (x[2] & y[3]), y[2] if y[4] else x[2] | y[2],
            x[3] if x[4] else x[3] | y[3], x[4] | y[4])


def fold_in_order(sums):
    acc = sums[0]
    for y in sums[1:]:
        acc = combine(acc, y)
    return acc


def word_scan_emulation(u8, true_len, n_blocks, pattern, *, icase=False, wword=False,
                        prev_word=0, start_limit=None, mask_kind=None, lines_on=True):
    """The kernel's (n_blocks, 8) int32 stats and u8 mask (None without a
    mask kind; a first_line mask before the cross-block fix-up), step by
    step over numpy arrays shaped (block, warp, lane)."""
    text = np.asarray(u8, np.uint8)
    m = len(pattern)
    cls = 0 if m <= 4 else 1 if m <= 8 else 2
    pat = literal.fold_bytes_host(pattern) if icase else pattern
    pw = pattern_words(pat, (m + 3) // 4 + 2)
    p0, p1 = pw[0], pw[1]
    m0 = np.uint64(0xFFFFFFFF if m >= 4 else (1 << (8 * m)) - 1)
    m1 = np.uint64(0xFFFFFFFF if m >= 8 else 0 if m <= 4 else (1 << (8 * (m - 4))) - 1)
    limit = swar.NO_LIMIT if start_limit is None else start_limit
    words = text[: len(text) // 4 * 4].view("<u4").astype(np.uint64)
    fw = fold4(words) if icase else words  # -i folds each loaded word
    # the body and the 16 bytes after it (the lanes past them read nothing)
    chunks = np.zeros(((n_blocks * BLOCK + STRIDE) // 16, 4), np.uint64)
    chunks[: n_blocks * BLOCK // 16 + 1] = fw[: (n_blocks * BLOCK + 16) // 4].reshape(-1, 4)
    B = n_blocks
    b_ix = np.arange(B)[:, None, None]
    w_ix = np.arange(WARPS)[None, :, None]
    l_ix = np.arange(32)[None, None, :]
    base = (b_ix * BLOCK)[..., 0]                           # (B, 1)
    hit_end = np.minimum(true_len - m, limit - 1) - base + 1
    nl_end = limit - base
    past = (limit <= base)[:, 0]                             # blocks wholly past the limit

    count = np.zeros((B, WARPS, 32), np.int64)
    wl = WarpLines(B)
    flags_all = np.zeros((B, WARPS, STRIDES, 32), np.uint64)
    warp_off = w_ix[..., 0] * WARP_BYTES                     # (1, WARPS)
    g_before = base + warp_off - 1
    carry = np.where(base + warp_off > 0, np.vectorize(naive.is_word_char)(
        text[np.maximum(g_before, 0)]), bool(prev_word)).astype(np.uint64)
    for k in range(STRIDES):
        so = warp_off + k * STRIDE                           # (1, WARPS)
        lo = so[..., None] + 16 * l_ix                       # (1, WARPS, 32)
        c = b_ix * (BLOCK // 16) + w_ix * (WARP_BYTES // 16) + k * 32 + l_ix
        cur = chunks[c]                                      # (B, WARPS, 32, 4)
        nxt = chunks[c + 32]
        if k == STRIDES - 1:  # past the warp's span only lane 0 has loaded
            nxt = np.where((l_ix == 0)[..., None], nxt, 0)
        src = np.where((l_ix == 0)[..., None], nxt, cur)    # lane 0 offers its next stride
        n = np.roll(src, -1, axis=2)                         # __shfl_sync from lane + 1
        W = [cur[..., 0], cur[..., 1], cur[..., 2], cur[..., 3], n[..., 0], n[..., 1]]
        hits = np.zeros(cur.shape[:3], np.uint64)
        for j in range(16):
            i, sh = j >> 2, 8 * (j & 3)
            ok = ((funnel(W[i], W[i + 1], sh) ^ p0) & m0) == 0
            if cls:
                ok &= ((funnel(W[i + 1], W[i + 2], sh) ^ p1) & m1) == 0
            hits |= ok.astype(np.uint64) << np.uint64(j)
        edge = (so + STRIDE > hit_end)[..., None]            # warp-uniform
        hits = np.where(edge, hits & low_bits16(hit_end[..., None] - lo), hits)
        nl_own = np.where(edge, low_bits16(nl_end[..., None] - lo), 0xFFFF).astype(np.uint64)
        if wword and cls < 2:
            # this lane's flags (made one stride ahead), the next lane's first
            # 8 (lane 31: the next stride's lane 0's), the previous lane's last
            if k == 0:
                wb_cur = word_bits16(cur)
            wb_nxt = word_bits16(nxt)
            after = np.roll(np.where(l_ix == 0, wb_nxt, wb_cur), -1, axis=2) & np.uint64(0xFF)
            wb = wb_cur | after << np.uint64(16)
            up = np.roll(wb_cur, 1, axis=2)                  # __shfl_up_sync by 1
            before = np.where(l_ix == 0, carry[..., None], (up >> np.uint64(15)) & np.uint64(1))
            carry = (wb_cur[..., 31] >> np.uint64(15)) & np.uint64(1)
            hits &= ~((wb << np.uint64(1)) | before) & ~(wb >> np.uint64(m)) & np.uint64(0xFFFF)
            wb_cur = wb_nxt
        if cls == 2 and hits.any():
            # the queue: each warp's candidates in lane order after a scan of the counts
            cnt = popc16(hits)
            excl = np.cumsum(cnt, axis=2) - cnt
            bb, ww, ll = np.nonzero(hits)
            pos, slot, owner = [], [], []
            for b_, w_, l_ in zip(bb, ww, ll):
                h, o = int(hits[b_, w_, l_]), int(excl[b_, w_, l_])
                while h:
                    pos.append(int(lo[0, w_, l_]) + ffs16(h))
                    slot.append(o)
                    owner.append((b_, w_))
                    o += 1
                    h &= h - 1
            assert max(slot) < STRIDE
            p = np.array(pos)
            ob = np.array([x[0] for x in owner])
            ok = verify_rest(fw, text, ob * BLOCK + p, pw, m, wword, prev_word)
            bitmap = np.zeros((B, WARPS, STRIDE // 32), np.uint64)
            s_w = p - (warp_off[0, [x[1] for x in owner]] + k * STRIDE)
            np.bitwise_or.at(bitmap, (ob[ok], np.array([x[1] for x in owner])[ok], s_w[ok] >> 5),
                             np.uint64(1) << u64(p[ok] & 31))
            hits = (bitmap[:, :, l_ix[0, 0] >> 1] >> u64(16 * (l_ix[0, 0] & 1))) & np.uint64(0xFFFF)
        flags = hits
        count += popc16(hits)
        if lines_on:
            nl = nl_own & (newline_bits4(W[0]) | newline_bits4(W[1]) << np.uint64(4) |
                           newline_bits4(W[2]) << np.uint64(8) |
                           newline_bits4(W[3]) << np.uint64(12))
            fst = wl.fold(hits, nl, so)
            if mask_kind == "first_line":
                flags = fst
        flags_all[:, :, k] = flags

    stats = np.zeros((B, 8), np.int64)
    mask = None
    if mask_kind is not None:
        bits = (flags_all[..., None] >> np.arange(16, dtype=np.uint64)) & np.uint64(1)
        mask = bits.astype(np.uint8).reshape(-1)  # (block, warp, stride, lane, 16): text order
    wsum = wl.warp_sums(count)
    lead_off = wl.lead_off
    for b in range(B):
        if past[b]:
            stats[b] = 0
            if mask_kind == "first_line":
                stats[b, 5] = -1
            if mask is not None:
                mask[b * BLOCK : (b + 1) * BLOCK] = 0
            continue
        if mask_kind == "first_line":
            for w in range(WARPS):
                if lead_off[b, w] < 0:
                    continue
                for u in range(w - 1, -1, -1):
                    if wsum[b][u][2]:
                        mask[b * BLOCK + lead_off[b, w]] = 0
                        break
                    if wsum[b][u][4]:
                        break
        stats[b, :5] = fold_in_order(wsum[b])
        if mask_kind == "first_line":
            stats[b, 5] = -1
            for w in range(WARPS):
                if wsum[b][w][3]:
                    stats[b, 5] = b * BLOCK + lead_off[b, w]
                    break
                if wsum[b][w][4]:
                    break
    return (torch.from_numpy(stats.astype(np.int32)),
            None if mask is None else torch.from_numpy(mask))


# ------------------------------------------------------------------ texts

EDGES = [16 * 5 - 1, 16 * 9 - 2, STRIDE - 1, 3 * STRIDE - 3, WARP_BYTES - 1, 3 * WARP_BYTES - 2,
         BLOCK - 1, BLOCK - 2, BLOCK + 15, BLOCK + WARP_BYTES - 3, BLOCK + 5 * STRIDE - 1]


def edge_text(pattern: bytes, seed: int, size: int = 2 * BLOCK - 40, long_lines=False) -> bytes:
    """English text of two blocks with `pattern` planted across lane,
    stride, warp and block edges, after "_^" (-w) and to end at the text's
    end; with long_lines, runs of lines that span several warps."""
    text = bytearray(naive.gen_english(seed, size + 1000)[:size])
    if long_lines:
        rng = np.random.default_rng(seed)
        for at in rng.integers(0, size - 30_000, 4):
            seg = text[at : at + int(rng.integers(9000, 30_000))]
            text[at : at + len(seg)] = seg.replace(b"\n", b" ")
    for at in EDGES:
        text[at : at + len(pattern)] = pattern
    at = 40_000 + 4 * seed
    text[at : at + len(pattern) + 3] = b"_^" + pattern + b" "
    text[size - len(pattern) :] = pattern
    return bytes(text[:size])


def cut_pattern(text: bytes, m: int, at: int = 3001) -> bytes:
    start = text.index(b"\n", at) + 1
    return text[start : start + m]


def check_k1(tst, pat, **kw):
    """The emulation against literal.block_stats, exactly, with the start
    mask (whose stats the count instance shares) and the first_line mask;
    returns the count."""
    tl = kw.pop("true_len", tst.true_len)
    for kind in ("starts", "first_line"):
        stats, mask = word_scan_emulation(
            tst.u8.numpy(), tl, tst.n_blocks, pat, icase=not kw.get("case_sensitive", True),
            wword=kw.get("whole_word", False), prev_word=kw.get("prev_word", 0),
            start_limit=kw.get("start_limit"), mask_kind=kind)
        pstats, pmask = literal.block_stats(tst.u8, tl, tst.n_blocks, pattern=pat,
                                            want_mask=True, mask_kind=kind, **kw)
        assert torch.equal(stats, pstats), (kind, stats, pstats)
        if kind == "starts":
            cstats, _ = literal.block_stats(tst.u8, tl, tst.n_blocks, pattern=pat, **kw)
            assert torch.equal(stats, cstats)
        else:
            mask = lines.first_line_fixup(stats, mask)
        assert torch.equal(mask, pmask), kind
    return int(stats[:, 0].sum())


# ------------------------------------------------------------------ K=1 scan

@pytest.mark.parametrize("m", [1, 3, 5, 9, 17, 64])
def test_k1_word_scan_matches_plain(m):
    """count, starts and first_line masks with and without -i and -w; the
    shard mode with start_limit inside a lane's 16 bytes, prev_word 0 and
    1 and the match bound at start_limit + m - 1."""
    base = naive.gen_english(m, 5000)
    pat = {1: b"e", 3: b"the"}.get(m) or cut_pattern(base, m)
    text = edge_text(pat, m, long_lines=m in (3, 17))
    tst = dispatch.stage(text, CPU)
    assert tst.n_blocks == 2
    n = 0
    for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
        p = pat if cs else pat.upper()
        n += check_k1(tst, p, case_sensitive=cs, whole_word=ww)
    assert n > len(EDGES)  # the plants matched (some overlap, -w rejects some)
    limit = BLOCK + WARP_BYTES + 2 * STRIDE + 16 * 7 + 5  # inside a lane's 16 bytes
    for prev in (0, 1):
        for cs, ww in [(True, False), (False, True)]:
            check_k1(tst, pat, case_sensitive=cs, whole_word=ww, prev_word=prev,
                     start_limit=limit, true_len=limit + m - 1)
    # the limit in block 0: block 1 lies wholly past it
    check_k1(tst, pat, whole_word=True, prev_word=1, start_limit=STRIDE * 3 + 9,
             true_len=STRIDE * 3 + 8 + m)


def test_k1_dense_candidates_match_plain():
    """Runs of one byte and a 17-byte pattern whose prefix repeats: every
    position of a run is a filter candidate, so each warp's queue fills."""
    text = bytearray(b"a" * (2 * BLOCK - 100))
    for at in range(0, len(text), 997):
        text[at] = 10 if at % 3 else ord("b")
    text[BLOCK - 8 : BLOCK + 9] = b"a" * 16 + b"b"
    tst = dispatch.stage(bytes(text), CPU)
    for pat in (b"a" * 16 + b"b", b"aaaa", b"a" * 9):
        assert check_k1(tst, pat) > 0


def test_k1_word_scan_matches_pallas():
    """The emulation against interpret-mode pallas_swar.scan_literal (-i)
    and scan_shard (prev_word 1, an element-aligned limit), on text without
    "_^" (the reference's -w fault)."""
    text = edge_text(b"the", 5).replace(b"_^", b"x ")
    jst = jdispatch.stage(text)
    tst = convert.staged_from_reference(jst._np, len(text), CPU)
    c, nlines, mk = pallas_swar.scan_literal(jst.u32, jst.true_len, pattern=b"THE",
                                             case_sensitive=False, want_mask=True, interpret=True)
    stats, mask = word_scan_emulation(tst.u8.numpy(), tst.true_len, tst.n_blocks, b"THE",
                                      icase=True, mask_kind="starts")
    assert lines.combine_block_stats(stats)[:2].tolist() == [int(c), int(nlines)]
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    limit = BLOCK + 16 * 251
    pat = cut_pattern(text, 5)
    c, f, trail, lead, has_nl, mk = pallas_swar.scan_shard(
        jst.u32, jnp.int32(limit + 4), jnp.int32(1), jnp.int32(limit), pattern=pat,
        whole_word=True, want_mask=True, interpret=True)
    stats, mask = word_scan_emulation(tst.u8.numpy(), limit + 4, tst.n_blocks, pat, wword=True,
                                      prev_word=1, start_limit=limit, mask_kind="starts")
    got = lines.combine_block_stats(stats)[:5].tolist()
    assert got == [int(c), int(f), int(trail), int(lead), int(has_nl)]
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])


# ------------------------------------------------------------------ byte scan

@pytest.mark.parametrize("m", [1, 3, 5, 9, 17, 64, 65, 1000])
def test_byte_word_scan_matches_plain(m):
    """The byte scan's instances (count and mask, -i, -w) and its variants
    against bytescan.block_stats_bytes / variant_stats_plain, exactly."""
    base = naive.gen_english(100 + m, 5000)
    pat = {1: b"t", 3: b"the"}.get(m) or cut_pattern(base, m)
    text = edge_text(pat, 100 + m)
    tst = dispatch.stage(text, CPU)
    for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
        p = pat if cs else pat.upper()
        for want_mask in (False, True):
            pstats, pmask = bytescan.block_stats_bytes(tst.u8, tst.true_len, tst.n_blocks,
                                                       pattern=p, case_sensitive=cs,
                                                       whole_word=ww, want_mask=want_mask)
            stats, mask = word_scan_emulation(tst.u8.numpy(), tst.true_len, tst.n_blocks, p,
                                              icase=not cs, wword=ww,
                                              mask_kind="starts" if want_mask else None)
            assert torch.equal(stats, pstats), (cs, ww, want_mask)
            if want_mask:
                assert torch.equal(mask, pmask)
            if cs and not ww:
                assert int(stats[:, 0].sum()) >= len(EDGES) - 2  # some plants overlap
    for mode, lines_on in (("compares_only", False), ("lines_only", True), ("full", True)):
        want = bytescan.variant_stats_plain(tst.u8, tst.true_len, tst.n_blocks, mode=mode,
                                            pattern=pat)
        got, _ = word_scan_emulation(tst.u8.numpy(), tst.true_len, tst.n_blocks, pat,
                                     lines_on=lines_on)
        assert torch.equal(got, want), mode


def test_byte_word_scan_matches_pallas_scan():
    """The emulation against interpret-mode pallas_scan.scan_literal, a
    17-byte pattern with -i across the block edge."""
    text = edge_text(b"Sherlock Holmes w", 9)
    jst = jdispatch.stage(text)
    tst = convert.staged_from_reference(jst._np, len(text), CPU)
    c, nlines, mk = pallas_scan.scan_literal(jst.u8, jst.true_len, pattern=b"SHERLOCK holmes W",
                                             case_sensitive=False, want_mask=True,
                                             interpret=True)
    stats, mask = word_scan_emulation(tst.u8.numpy(), tst.true_len, tst.n_blocks,
                                      b"SHERLOCK holmes W", icase=True, mask_kind="starts")
    assert lines.combine_block_stats(stats)[:2].tolist() == [int(c), int(nlines)]
    assert np.array_equal(mask.numpy(), np.asarray(mk)[: mask.shape[0]].astype(np.uint8))
    assert int(c) >= len(EDGES)


# ------------------------------------------------------------ lines kernel

def nonzero_bits16(v):
    """lines_scan.cu nonzero_bits16: the non-zero bytes of a lane's 4 words."""
    b = (u64(v)[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)
    bits = ((b != 0).astype(np.uint64) << np.arange(4, dtype=np.uint64)).sum(-1, dtype=np.uint64)
    return (bits[..., 0] | bits[..., 1] << np.uint64(4) | bits[..., 2] << np.uint64(8) |
            bits[..., 3] << np.uint64(12))


def lines_emulation(u8, mask, n_blocks):
    """csrc/lines_scan.cu step by step: each warp's 8 KiB in strides of 512
    bytes, lane l holding 16 text bytes and the same 16 mask bytes; the hit
    word from the non-zero mask bytes, the newline word, count the popc of
    the hits, the shared line fold (WarpLines.fold), the warps' summaries
    in order. Returns the (n_blocks, 8) int32 rows."""
    body = n_blocks * BLOCK
    text = np.asarray(u8, np.uint8)[:body].view("<u4").astype(np.uint64).reshape(-1, 4)
    flags = np.asarray(mask, np.uint8)[:body].view("<u4").astype(np.uint64).reshape(-1, 4)
    b_ix = np.arange(n_blocks)[:, None, None]
    w_ix = np.arange(WARPS)[None, :, None]
    l_ix = np.arange(32)[None, None, :]
    count = np.zeros((n_blocks, WARPS, 32), np.int64)
    wl = WarpLines(n_blocks)
    for k in range(STRIDES):
        c = b_ix * (BLOCK // 16) + w_ix * (WARP_BYTES // 16) + k * 32 + l_ix
        t = text[c]
        hits = nonzero_bits16(flags[c])
        nl = (newline_bits4(t[..., 0]) | newline_bits4(t[..., 1]) << np.uint64(4) |
              newline_bits4(t[..., 2]) << np.uint64(8) | newline_bits4(t[..., 3]) << np.uint64(12))
        count += popc16(hits)
        wl.fold(hits, nl, w_ix[..., 0] * WARP_BYTES + k * STRIDE)
    wsum = wl.warp_sums(count)
    stats = np.zeros((n_blocks, 8), np.int64)
    for b in range(n_blocks):
        stats[b, :5] = fold_in_order(wsum[b])
    return torch.from_numpy(stats.astype(np.int32))


def lines_text(n_blocks: int, seed: int) -> np.ndarray:
    """n_blocks * 64 KiB of English text (a partial last block on three
    blocks, as a staging bucket pads it), with a line of two blocks and
    more on three blocks (from the end of block 0 on: blocks 1 and 2 hold
    no newline)."""
    size = n_blocks * BLOCK - (20_000 if n_blocks == 3 else 0)
    text = np.frombuffer(naive.gen_english(seed, size + 1000)[:size], np.uint8).copy()
    if n_blocks == 3:
        seg = text[BLOCK - 300 :]
        seg[seg == 10] = 32
    return text


def lines_mask(text: np.ndarray, body: int, seed: int, nl_flags: bool) -> np.ndarray:
    """A 0/1 start mask: sparse random flags, flags on both sides of lane,
    stride, warp and block edges, some on newline bytes (nl_flags), and a
    run of flags across a lane."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(body, np.uint8)
    n = text.shape[0]
    mask[:n] = rng.random(n) < 0.004
    for e in EDGES:
        for at in (e, e + 1):
            if at < n:
                mask[at] = 1
    nl = np.flatnonzero(text == 10)
    mask[nl] = 0
    if nl_flags:
        mask[nl[::5]] = 1
    mask[3 * STRIDE + 5 : 3 * STRIDE + 40] = 1
    return mask


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("nl_flags", [False, True], ids=["plain", "flags on newlines"])
def test_lines_kernel_model_matches_plain(n_blocks, nl_flags):
    """The lines kernel's model against literal.lines_block_stats, exactly
    (integers): flags on newline bytes or none, lines across lane, stride,
    warp and block edges, blocks with no newline (three blocks), an
    all-zero mask."""
    text = lines_text(n_blocks, 40 + n_blocks)
    tst = dispatch.stage(text.tobytes(), CPU)
    assert tst.n_blocks == n_blocks
    body = n_blocks * BLOCK
    u8 = tst.u8.numpy()
    for mask in (lines_mask(text, body, n_blocks, nl_flags), np.zeros(body, np.uint8)):
        want = literal.lines_block_stats(tst.u8, torch.from_numpy(mask), n_blocks)
        got = lines_emulation(u8, mask, n_blocks)
        assert torch.equal(got, want), (n_blocks, nl_flags, int(mask.sum()))
    if n_blocks == 3:
        assert int(got[1, 4]) == 0 and int(got[2, 4]) == 0  # no newline in blocks 1 and 2


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_lines_kernel_model_matches_pallas(n_blocks):
    """The lines kernel's model against interpret-mode
    pallas_swar.lines_from_mask (nl_start_matches on: some flags sit on
    newline bytes, as the caller sets it for a '\\n'-leading member)."""
    text = lines_text(n_blocks, 50 + n_blocks)[: n_blocks * BLOCK - 5000]
    jst = jdispatch.stage(text.tobytes())
    tst = convert.staged_from_reference(jst._np, text.shape[0], CPU)
    body = tst.n_blocks * BLOCK
    mask = lines_mask(text, body, n_blocks, True)
    want = int(pallas_swar.lines_from_mask(jst.u32, mask.view(np.uint32), jst.true_len,
                                           nl_start_matches=True, interpret=True))
    got = lines.combine_block_stats(lines_emulation(tst.u8.numpy(), mask, tst.n_blocks))
    assert int(got[1]) == want == naive.matched_lines(text.tobytes(), np.flatnonzero(mask).tolist())


# --------------------------------------------------------------- scan tail

TAIL_THREADS = 256
GROUP_BLOCKS = 64  # scan_common.cuh kGroupBlocks


def fold_rows_model(summ):
    """scan_common.cuh fold_rows over n <= 512 summaries: passes of 256,
    thread t taking summary r0 + t, warp_fold's ordered tree over each
    warp's 32 lanes (shfl_down by 1, 2, 4, 8, 16, the lower lane folding
    the upper), then the 8 warp sums in order onto the passes before."""
    assert len(summ) <= 2 * TAIL_THREADS
    b = (0, 0, 0, 0, 0)
    for r0 in range(0, len(summ), TAIL_THREADS):
        thread = [summ[r0 + t] if r0 + t < len(summ) else (0, 0, 0, 0, 0)
                  for t in range(TAIL_THREADS)]
        for w in range(TAIL_THREADS // 32):
            lanes = thread[32 * w : 32 * w + 32]
            off = 1
            while off < 32:
                lanes = [combine(lanes[i], lanes[i + off]) if i % (2 * off) == 0 else lanes[i]
                         for i in range(32)]
                off *= 2
            b = combine(b, lanes[0])
    return b


def tail_fold_model(rows: np.ndarray) -> list[int]:
    """scan_common.cuh finish_blocks: each group of GROUP_BLOCKS rows folded
    by fold_rows (by the group's last block), then the group rows by
    fold_rows (by the launch's last group). Returns the 8 totals."""
    summ = [tuple(int(x) for x in r[:5]) for r in rows]
    groups = [fold_rows_model(summ[g : g + GROUP_BLOCKS])
              for g in range(0, len(summ), GROUP_BLOCKS)]
    b = fold_rows_model(groups)
    count = (b[0] + (1 << 31)) % (1 << 32) - (1 << 31)  # the kernel's int32 sum wraps
    return [count, *b[1:], 0, 0, 0]


def tail_rows(rng, n: int, past: int) -> np.ndarray:
    """(n, 8) int32 block rows that real text could give (a block without a
    newline has trail == lead == (count > 0)), the last `past` of them all
    zero, as blocks past start_limit write them; also a zero run inside."""
    rows = np.zeros((n, 8), np.int32)
    rows[:, 0] = rng.integers(0, 50, n) * (rng.random(n) < 0.6)
    any_match = rows[:, 0] > 0
    rows[:, 1] = np.minimum(rows[:, 0], rng.integers(1, 20, n))
    has_nl = rng.random(n) < 0.7
    rows[:, 2] = np.where(has_nl, any_match & (rng.random(n) < 0.5), any_match)
    rows[:, 3] = np.where(has_nl, any_match & (rng.random(n) < 0.5), any_match)
    rows[:, 4] = has_nl
    rows[n - past :] = 0
    if n > 40:
        rows[n // 3 : n // 3 + 17] = 0
    return rows


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1536, 16_384, 24_576])
def test_tail_fold_model_matches_combine(n):
    """The scan tail's fold order (groups of 64 rows, then the group rows;
    each a row per thread, warp_fold and the warp sums) against
    lines.combine_block_stats, exactly (integers):
    rows as real text gives them, with runs of all-zero rows as blocks past
    start_limit write them (a third of the 1 GiB slab's 24,576)."""
    rng = np.random.default_rng(n)
    for past in sorted({0, n // 3, n - 1}):
        rows = tail_rows(rng, n, past)
        want = lines.combine_block_stats(torch.from_numpy(rows)).tolist()
        assert tail_fold_model(rows) == want, (n, past)
