"""krep_tpu_torch's multi-pattern path against the JAX package, on the CPU.

The port's plain versions of its three multi-pattern kernels
(literal.block_stats_multi, literal.lines_block_stats,
mxu.hamming_scan_plain) are held to the Pallas kernels they replace in
interpret mode (pallas_swar.scan_multi, pallas_swar.lines_from_mask,
mxu_multi.scan_count), on the same staged bytes; the port's
search_string and CLI to krep_tpu's, on every multi-pattern route. Inputs
are made from fixed seeds; every comparison is exact equality.

The Pallas kernels' -w drops matches after "_^" (ROADMAP queue 3), so the
texts held to them hold no "^", and "_^" cases are held to tests/naive.py.
"""

import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krep_tpu
import naive
from krep_tpu import cli as jcli
from krep_tpu.ops import dispatch as jdispatch
from krep_tpu.ops import mxu_multi, pallas_swar
from krep_tpu_torch import SearchParams, cli, convert, search_string
from krep_tpu_torch.engine import search as search_mod
from krep_tpu_torch.ops import dispatch, literal, mxu, multi, swar
from krep_tpu_torch.parallel import lines
from test_torch_search import jax_params

CPU = torch.device("cpu")
REF_HOST = str(1 << 40)  # KREP_TPU_HOST_BREAKEVEN that sends krep_tpu to its native host route

ALPHABET = b"abcdeAB_9 \n\nthe quick"
WORDS = sorted(set(naive.gen_english(1, 4000).split()))  # 29 distinct words, 1-10 bytes


def stage_both(text: bytes):
    jst = jdispatch.stage(text)
    return jst, convert.staged_from_reference(jst._np, len(text), CPU)


def union_starts(text: bytes, patterns, cs=True, ww=False) -> list[int]:
    return sorted({s for p in patterns for s in naive.all_starts(text, p, cs, ww)})


def mixed_set(k: int, seed: int) -> tuple[bytes, ...]:
    """k distinct members of 4-20 bytes cut from the corpus vocabulary, as
    bench.py builds config 3c's set (members over 13 bytes take the second
    window)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        ws = [WORDS[int(i)] for i in rng.integers(0, len(WORDS), int(rng.integers(1, 4)))]
        p = b" ".join(ws)[: int(rng.integers(4, 21))]
        if len(p) >= 4 and p not in out:
            out.append(p)
    return tuple(out)


def variants(k: int) -> tuple[bytes, ...]:
    """k distinct members: the vocabulary, then numbered 8-byte variants
    (bench.py's 64-literal recipe)."""
    out = []
    i = 0
    while len(out) < k:
        w = WORDS[i % len(WORDS)]
        r = i // len(WORDS)
        p = (w[:5] + str(r).encode() if r else w)[:8]
        if p not in out:
            out.append(p)
        i += 1
    return tuple(out)


# ---------------------------------------------------------------- kernel A

SETS_A = {
    "K2": (b"the", b"he"),
    "K5-overlap-prefix-1byte-nl": (b"a", b"ab", b"abc", b"\nthe", b"e a"),
    "K16": variants(16),
    "K64-len64": variants(63) + ((bytes(range(97, 123)) * 3)[:64],),
}


@pytest.mark.parametrize(
    "name,cs,ww",
    [("K2", True, False), ("K5-overlap-prefix-1byte-nl", False, False),
     ("K16", True, True), ("K64-len64", False, True)],
)
def test_block_stats_multi_matches_pallas_scan_multi(name, cs, ww):
    patterns = SETS_A[name]
    text = naive.gen_corpus(11, 3000, ALPHABET) + b" ".join(patterns)
    jst, tst = stage_both(text)
    c, l, mk = pallas_swar.scan_multi(
        jst.u32, jst.true_len, patterns=patterns, case_sensitive=cs,
        whole_word=ww, want_mask=True, want_lines=True, interpret=True,
    )
    stats, mask = literal.block_stats_multi(
        tst.u8, tst.true_len, tst.n_blocks, patterns=patterns,
        case_sensitive=cs, whole_word=ww, want_mask=True,
    )
    tot = lines.combine_block_stats(stats)
    assert tot[:2].tolist() == [int(c), int(l)]
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    want = union_starts(text, patterns, cs, ww)
    assert torch.nonzero(mask).squeeze(1).tolist() == want
    # the staged route returns the same, with per-block match counts
    totals, mask2, group_counts = dispatch.scan_multi_staged(
        tst, patterns=patterns, case_sensitive=cs, whole_word=ww, want_mask=True,
    )
    assert torch.equal(totals, tot) and torch.equal(mask2, mask)
    assert torch.equal(group_counts, stats[:, 0])


@pytest.mark.parametrize("text", [b"_^ab cd\n", b"_^ab_^ab ^ab\ncd_^cd\n", b"x_^^cd_ab^\n"])
def test_block_stats_multi_whole_word_after_underscore_caret(text):
    """-w after "_^": held to naive (the Pallas kernels drop these)."""
    patterns = (b"ab", b"cd", b"^ab")
    text = text * 300
    tst = dispatch.stage(text, CPU)
    stats, mask = literal.block_stats_multi(
        tst.u8, tst.true_len, tst.n_blocks, patterns=patterns, whole_word=True,
        want_mask=True,
    )
    per = [naive.all_starts(text, p, True, True) for p in patterns]
    want = sorted({s for ss in per for s in ss})
    assert torch.nonzero(mask).squeeze(1).tolist() == want
    tot = lines.combine_block_stats(stats)
    assert tot[:2].tolist() == [sum(map(len, per)), naive.matched_lines(text, want)]


def test_block_stats_multi_across_blocks():
    """Matches that straddle the 64 KiB block edges, and -w before-bytes in
    the previous block, over three blocks."""
    patterns = (b"edge", b"ab", b"x")
    text = bytearray(naive.gen_corpus(12, 200_000, b"cde xy_\n"))
    text[65534:65538] = b"edge"     # straddles the first block edge
    text[131071:131075] = b"_ab "   # -w before-byte in the previous block: no match
    text[196607:196611] = b" ab "   # ... a space there: a match
    text = bytes(text)
    tst = dispatch.stage(text, CPU)
    for cs, ww in ((True, False), (False, True)):
        stats, mask, totals = swar.scan_blocks_multi(
            tst.u8, tst.true_len, tst.n_blocks, patterns=patterns,
            case_sensitive=cs, whole_word=ww, want_mask=True,
        )
        per = [naive.all_starts(text, p, cs, ww) for p in patterns]
        want = sorted({s for ss in per for s in ss})
        assert torch.nonzero(mask).squeeze(1).tolist() == want
        assert torch.equal(totals, swar.combine_blocks(stats))
        assert totals[:2].tolist() == [
            sum(map(len, per)), naive.matched_lines(text, want)
        ]


def test_pattern_set_layout():
    """The K-pattern kernel's tables: each member's words (word-major) and
    length, the filter map bit of its prefix (lengths 3 and 4 in one map
    word where the set has both), the buckets that list the members by
    (prefix length, top 8 bits of key * the length's multiplier), in input
    order within a bucket, the multipliers that keep distinct prefixes
    apart, and the prefix lengths the set has."""
    patterns = (b"the", b"a", b"tab", bytes(range(1, 65)), b"\nx", b"then", b"the")
    buf = swar.multi_tables(patterns)
    assert buf.shape == (swar.MULTI_TABLE_BYTES,)
    lens = buf[swar._T_LEN : swar._T_LIST]
    assert lens[: len(patterns)].tolist() == [3, 1, 3, 64, 2, 4, 3] and not lens[7:].any()
    words = buf[swar._T_WORDS : swar._T_LEN].view("<u4").reshape(16, swar.MAX_PATTERNS)
    rows = words.T.copy().view(np.uint8)  # word-major: word i of member k at [i][k]
    for k, p in enumerate(patterns):
        assert rows[k, : len(p)].tobytes() == p and not rows[k, len(p) :].any()
    bits = np.unpackbits(buf[swar._T_MAP : swar._T_WORDS], bitorder="little")
    assert swar.prefix_hash(b"the") == int.from_bytes(b"the", "little") * swar.HASH_MULT[2] % (1 << 32)
    assert np.flatnonzero(bits).tolist() == sorted({swar.map_bit(p[:4]) for p in patterns})
    h3, h4 = swar.prefix_hash(b"the"), swar.prefix_hash(b"then")  # "then" reads the word of "the"
    assert swar.map_bit(b"then") == (h3 >> 22) * 32 + (h4 >> 17) % 32
    assert swar.map_bit(b"then", joint=False) == h4 >> 17
    mults = buf[swar._T_MULT : swar._T_MULT + 16].view("<u4").tolist()
    off = buf[swar._T_OFF : swar._T_OFF + 4 * 256 + 1]
    listed = buf[swar._T_LIST : swar._T_LIST + len(patterns)]
    for n in range(1, 5):
        for b in range(256):
            i = 256 * (n - 1) + b
            assert listed[off[i] : off[i + 1]].tolist() == [
                k for k, p in enumerate(patterns) if min(len(p), 4) == n
                and swar.prefix_hash(p[:n], mults[n - 1]) >> 24 == b
            ]
    assert off[-1] == len(patterns)
    present = int(buf[swar._T_PRESENT : swar._T_PRESENT + 4].view("<u4")[0])
    assert present == 0b1111
    # bench.py's 64 variants: members of different 4-byte prefixes never share a bucket
    mults = swar.multi_tables(variants(64))[swar._T_MULT : swar._T_MULT + 16].view("<u4")
    prefixes = {p[:4] for p in variants(64) if len(p) >= 4}
    assert len({swar.prefix_hash(q, int(mults[3])) >> 24 for q in prefixes}) == len(prefixes)
    assert swar.bucket_mult([7, 7]) == swar.HASH_MULT[0]


def test_device_tables_cached_per_folded_set():
    """The kernel's device tables are built once per (folded set, case,
    device): a second call returns the same tensor; -i and case-sensitive
    calls never share one, even where folding leaves the set unchanged."""
    pats = (b"The", b"fox")
    cs = swar.device_multi_tables(pats, True, CPU)
    assert swar.device_multi_tables(list(pats), True, "cpu") is cs
    ci = swar.device_multi_tables(pats, False, CPU)
    assert ci is not cs
    assert np.array_equal(cs.numpy(), swar.multi_tables(pats))
    assert np.array_equal(ci.numpy(), swar.multi_tables((b"the", b"fox")))
    assert swar.device_multi_tables((b"THE", b"fox"), False, CPU) is ci  # the same folded set
    lower = (b"the", b"fox")
    a, b = swar.device_multi_tables(lower, True, CPU), swar.device_multi_tables(lower, False, CPU)
    assert a is not b and torch.equal(a, b) and a is not ci


def _fold_bits(s, state, hits, nl):
    """csrc/scan_common.cuh fold_bits on int64 arrays (one entry per
    thread): 32 positions of hit and newline bits into the summaries
    s = [count, first, trail, lead, has_nl]."""
    full = 0xFFFFFFFF
    gen, prop = hits & ~nl & full, ~nl & full
    total = gen + prop + state
    open_ = (total ^ gen ^ prop) & full
    s[1] += np.unpackbits((hits & ~open_ & full).astype("<u4").view(np.uint8)).reshape(
        len(hits), 32).sum(1, dtype=np.int64)
    upto = np.where(nl != 0, (nl ^ (nl - 1)) & full, full)
    s[3] |= (s[4] == 0) & ((hits & upto) != 0)
    s[4] |= nl != 0
    return total >> 32


def _combine(x, y):
    return [x[0] + y[0], x[1] + y[1] - (x[2] & y[3]), y[2] if y[4] else x[2] | y[2],
            x[3] if x[4] else x[3] | y[3], x[4] | y[4]]


def multi_kernel_emulation(text: np.ndarray, true_len: int, n_blocks: int, tables: np.ndarray,
                           cs: bool, ww: bool, prev_word: int = 0, start_limit=None):
    """csrc/multi_scan.cu in numpy, driven only by its host-built tables: per
    64 KiB block, every position's 4-byte window through the filter map at
    each prefix length the set has, each candidate's bucket expanded into
    (position, member) items, each item verified 4 bytes at a time against
    the member's words (the last masked by its length) with the true_len
    bound, the -w tests and the shard bound; then each thread's 8 words of
    hit and newline bits folded as fold_bits does, and the 256 thread
    summaries in order. Returns (stats, mask) as scan_blocks_multi does."""
    b_ = literal.BLOCK_BYTES
    t = text if cs else literal._fold(torch.from_numpy(text)).numpy()
    isw = literal._is_word_char(torch.from_numpy(t)).numpy()
    mapbits = np.unpackbits(tables[swar._T_MAP : swar._T_WORDS], bitorder="little").astype(bool)
    words = tables[swar._T_WORDS : swar._T_LEN].view("<u4").reshape(16, 64).T.astype(np.int64)
    lens = tables[swar._T_LEN : swar._T_LIST].astype(np.int64)
    listed = tables[swar._T_LIST : swar._T_OFF].astype(np.int64)
    off = tables[swar._T_OFF : swar._T_OFF + 4 * 256 + 1].astype(np.int64)
    mults = tables[swar._T_MULT : swar._T_MULT + 16].view("<u4").astype(np.int64)
    present = int(tables[swar._T_PRESENT : swar._T_PRESENT + 4].view("<u4")[0])
    joint = present & 12 == 12
    stats = np.zeros((n_blocks, literal.STAT_WORDS), np.int32)
    mask = np.zeros(n_blocks * b_, np.uint8)
    pos = np.arange(b_)
    for blk in range(n_blocks):
        base = blk * b_
        seg = t[base : base + b_ + 64].astype(np.int64)
        win = seg[:-3] | seg[1:-2] << 8 | seg[2:-1] << 16 | seg[3:] << 24
        own = b_ if start_limit is None else min(max(start_limit - base, 0), b_)
        ps, ks = [], []
        for n in range(1, 5):
            if not present >> (n - 1) & 1:
                continue
            key = win[:b_] & ((1 << 8 * n) - 1)
            h = key * swar.HASH_MULT[n - 1] & 0xFFFFFFFF
            w = (win[:b_] & 0xFFFFFF) * swar.HASH_MULT[2] & 0xFFFFFFFF if n == 4 and joint else h
            cand = mapbits[(w >> 22) * 32 + (h >> 17) % 32] & (pos < own)
            bucket = 256 * (n - 1) + ((key[cand] * mults[n - 1] & 0xFFFFFFFF) >> 24)
            first, cnt = off[bucket], off[bucket + 1] - off[bucket]
            ps.append(np.repeat(pos[cand], cnt))
            item = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            ks.append(listed[np.repeat(first, cnt) + item])
        p, k = np.concatenate(ps), np.concatenate(ks)
        m = lens[k]
        ok = p + m <= true_len - base
        for i in range(16):
            rem = m - 4 * i
            part = np.where(rem >= 4, 0xFFFFFFFF, (1 << 8 * np.clip(rem, 0, 3)) - 1)
            ok &= (rem <= 0) | (((win[p + 4 * i] ^ words[k, i]) & part) == 0)
        if ww:
            prev0 = bool(isw[base - 1]) if blk else bool(prev_word)
            before = np.where(p > 0, isw[base + np.maximum(p - 1, 0)], prev0)
            ok &= ~before & ~isw[base + p + m]
        hits = np.zeros(b_, bool)
        hits[p[ok]] = True
        mask[base : base + b_] = hits
        nl = (seg[:b_] == literal.NEWLINE) & (pos < own)
        hw = np.packbits(hits, bitorder="little").view("<u4").reshape(256, 8).astype(np.int64)
        nw = np.packbits(nl, bitorder="little").view("<u4").reshape(256, 8).astype(np.int64)
        s, state = np.zeros((5, 256), np.int64), np.zeros(256, np.int64)
        for g in range(8):
            state = _fold_bits(s, state, hw[:, g], nw[:, g])
        s[2] = state
        block = [int(x) for x in s[:, 0]]
        for th in range(1, 256):
            block = _combine(block, [int(x) for x in s[:, th]])
        block[0] = int(ok.sum())
        stats[blk, :5] = block
    return torch.from_numpy(stats), torch.from_numpy(mask)


def _collision_set() -> tuple[bytes, ...]:
    """Members that collide in the kernel's filter map, over the alphabet
    of the test texts: two 4-byte prefixes of one map bit, and a 3-byte
    member whose map bit a 4-byte window also sets (lengths 3 and 4 share
    map words)."""
    import itertools

    by_bit, pair = {}, None
    for q in (bytes(x) for x in itertools.product(b"abcde_ ", repeat=4)):
        bit = swar.map_bit(q)
        if pair is None and bit in by_bit:
            pair = (by_bit[bit], q)
        by_bit.setdefault(bit, q)
    cross = next(bytes(r) for r in itertools.product(b"abcde_ ", repeat=3)
                 if swar.map_bit(bytes(r)) in by_bit)
    return (pair[0], pair[1] + b"c", cross, b"ab")


SETS_T = {
    # prefixes shared at 1, 2, 3 and 4 bytes; members that are prefixes of others
    "shared-prefixes": (b"a", b"ab", b"abc", b"abcd", b"abcde", b"abce", b"abd_", b"b", b"ba"),
    "lengths-1-2-3-64-nl": (b"e", b"c ", b"the", b"\nab", b"\n", b"e a",
                            (b"abcde_ " * 10)[:64]),
    "common-prefix-64": tuple(
        b"abcd" + bytes(x) for r in range(4) for x in __import__("itertools").product(
            b"abcde_ ", repeat=r))[:64],
    "collision": _collision_set(),
}


def set_text(patterns, seed: int, size: int) -> bytes:
    """Text over the sets' alphabet with every member planted often,
    ending in a member (matches at the last positions)."""
    rng = np.random.default_rng(seed)
    parts, n = [], 0
    while n < size:
        piece = naive.gen_corpus(int(rng.integers(1 << 30)), int(rng.integers(0, 9)),
                                 b"abcde_ \n\nthe")
        piece += patterns[int(rng.integers(len(patterns)))]
        parts.append(piece)
        n += len(piece)
    return b"".join(parts)[: size - 64] + patterns[-1]


def test_collision_set_collides():
    """The collision set does what it is built for: two 4-byte prefixes in
    one map bit, and a 3-byte member whose map bit a 4-byte window of the
    alphabet also sets."""
    import itertools

    pats = SETS_T["collision"]
    assert swar.map_bit(pats[0]) == swar.map_bit(pats[1][:4]) and pats[0] != pats[1][:4]
    assert len(pats[2]) == 3 and any(
        swar.map_bit(bytes(q)) == swar.map_bit(pats[2])
        for q in itertools.product(b"abcde_ ", repeat=4))


@pytest.mark.parametrize("name", list(SETS_T))
def test_kernel_tables_reproduce_plain_and_pallas(name):
    """The K-pattern kernel's filter, buckets and verify on its host-built
    tables (multi_kernel_emulation) give literal.block_stats_multi's
    summaries and mask exactly, with and without -i and -w, unbounded and
    with a shard start_limit and prev_word; one unbounded and one shard case
    per set (the unbounded one alone for the 64-member set, whose
    interpret-mode kernel is the slowest to build) are also held to
    interpret-mode pallas_swar.scan_multi / scan_shard_multi. Two blocks,
    members planted at the block edge and at the text's end; the limit
    lies inside a thread's span."""
    patterns = SETS_T[name]
    text = bytearray(set_text(patterns, 21, literal.BLOCK_BYTES + 6000))
    longest = max(patterns, key=len)
    text[literal.BLOCK_BYTES - 3 : literal.BLOCK_BYTES - 3 + len(longest)] = longest
    text = bytes(text)
    tst = dispatch.stage(text, CPU)
    u8 = tst.u8.numpy()
    m_max = max(map(len, patterns))
    limit = literal.BLOCK_BYTES + 256 * 7 + 100  # inside thread 7's span of block 1
    for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
        tables = swar.device_multi_tables(patterns, cs, CPU).numpy()
        for prev, sl in [(0, None), (1, limit)]:
            tl = tst.true_len if sl is None else sl + m_max - 1
            kw = dict(patterns=patterns, case_sensitive=cs, whole_word=ww, prev_word=prev,
                      start_limit=sl, want_mask=True)
            stats, mask = multi_kernel_emulation(u8, tl, tst.n_blocks, tables, cs, ww, prev, sl)
            pstats, pmask = literal.block_stats_multi(tst.u8, tl, tst.n_blocks, **kw)
            assert torch.equal(stats, pstats) and torch.equal(mask, pmask), (cs, ww, sl)
            assert int(stats[:, 0].sum()) > 0
    # the Pallas kernel on one unbounded and one shard case (text without "^")
    cs, ww = name != "collision", name in ("lengths-1-2-3-64-nl", "collision")
    jst = jdispatch.stage(text)
    c, ln, mk = pallas_swar.scan_multi(
        jst.u32, jst.true_len, patterns=patterns, case_sensitive=cs, whole_word=ww,
        want_mask=True, want_lines=True, interpret=True,
    )
    tables = swar.device_multi_tables(patterns, cs, CPU).numpy()
    stats, mask = multi_kernel_emulation(u8, tst.true_len, tst.n_blocks, tables, cs, ww)
    assert lines.combine_block_stats(stats)[:2].tolist() == [int(c), int(ln)]
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    if len(patterns) == 64:
        return
    tl = limit + m_max - 1
    c, f, trail, lead, has_nl, mk = pallas_swar.scan_shard_multi(
        jst.u32, jnp.int32(tl), jnp.int32(1), jnp.int32(limit), patterns=patterns,
        case_sensitive=cs, whole_word=ww, want_mask=True, interpret=True,
    )
    stats, mask = multi_kernel_emulation(u8, tl, tst.n_blocks, tables, cs, ww, 1, limit)
    got = lines.combine_block_stats(stats)[:5].tolist()
    assert got == [int(c), int(f), int(trail), int(lead), int(has_nl)]
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])


# ---------------------------------------------------------------- kernel C

SETS_C = {
    "one-window-K32": variants(32),
    "two-window-K40": mixed_set(40, 777),
    "whole-word-K33": variants(30) + (b"ab", b"the quick brown fox jump", b"x"),
}


@pytest.mark.parametrize(
    "name,cs,ww",
    [("one-window-K32", True, False), ("two-window-K40", False, False),
     ("whole-word-K33", False, True)],
)
def test_hamming_plain_matches_mxu_scan_count(name, cs, ww):
    patterns = SETS_C[name]
    assert any(len(p) > mxu.MAX_LEN for p in patterns) == (name != "one-window-K32")
    text = naive.gen_english(13, 3000) + b" ".join(patterns)
    if not cs:
        text = text.upper()
    jst, tst = stage_both(text)
    c, mk = mxu_multi.scan_count(
        jst.u32, jst.true_len, patterns=patterns, case_sensitive=cs,
        whole_word=ww, want_mask=True, interpret=True,
    )
    total, mask, group_counts = mxu.scan_count(
        tst, patterns=patterns, case_sensitive=cs, whole_word=ww, want_mask=True
    )
    assert int(total) == int(c) == sum(len(naive.all_starts(text, p, cs, ww)) for p in patterns)
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    assert torch.nonzero(mask).squeeze(1).tolist() == union_starts(text, patterns, cs, ww)
    assert int(group_counts.sum()) == int(total)


@pytest.mark.parametrize("text", [b"_^ab cd\n", b"_^ab_^ab ^ab\ncd_^cd\n"])
def test_hamming_whole_word_after_underscore_caret(text):
    """-w after "_^": held to naive (mxu_multi's boundary flags drop these)."""
    patterns = variants(30) + (b"ab", b"cd", b"^ab")
    text = text * 200
    tst = dispatch.stage(text, CPU)
    total, mask, _ = mxu.scan_count(tst, patterns=patterns, whole_word=True, want_mask=True)
    assert int(total) == sum(len(naive.all_starts(text, p, True, True)) for p in patterns)
    assert torch.nonzero(mask).squeeze(1).tolist() == union_starts(text, patterns, True, True)


@pytest.mark.parametrize("ww", [False, True], ids=["plain", "w"])
@pytest.mark.parametrize("name", list(SETS_C) + ["K256"])
def test_build_tables_matches_reference(name, ww):
    patterns = SETS_C.get(name) or mixed_set(256, 5)
    for cs in (True, False):
        ref = mxu_multi.build_tables(patterns, cs, ww)
        own = mxu.build_tables(patterns, cs, ww)
        for a, b in zip(ref[:6], own[:6]):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(np.asarray(a), b) and np.asarray(a).dtype == b.dtype
        assert ref[6:] == own[6:]
        conv = convert.mxu_tables_from_reference(ref, CPU)
        mine = mxu.device_tables(own, CPU)
        for f in mxu.HammingTables._fields:
            x, y = getattr(conv, f), getattr(mine, f)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), f


def kernel_layout_scan(text: torch.Tensor, n_blocks: int, t: mxu.HammingTables, cs: bool):
    """The Hamming kernel's arithmetic on its own operands, in numpy: G from
    its m16n8k32 A fragments in lane order, W from the B registers as the
    kernel builds them (lane 4g + tq, k-step ks, register r: the nibble at
    bit 4tq + 16r of text word w + ks, spread to bytes; -w flags at the
    boundary byte offsets), the second window on the long section's rows,
    each row's phase. Returns per-word counts and phase flags."""
    b = text.numpy() if cs else literal._fold(text).numpy()
    nw = n_blocks * literal.BLOCK_BYTES // 4
    words32 = b[: 4 * (nw + 16)].view("<u4").astype(np.uint64)  # the staged halo holds the tail

    def untile(frags):
        """(mt, ks, 32, 16) lane-order fragments -> the (16 mt, 32 ks) matrix."""
        mt, ks = frags.shape[:2]
        m = frags.numpy().reshape(mt, ks, 8, 4, 2, 2, 4).transpose(0, 5, 2, 1, 4, 3, 6)
        return m.reshape(16 * mt, 32 * ks).astype(np.float64)

    def b_rows(w0):
        """The B registers of window bytes 4 w0 .. 4 w0 + 15, as 128 W rows."""
        out = np.zeros((128, nw))
        for ks in range(4):
            x = words32[w0 + ks : w0 + ks + nw]
            for r in range(2):
                for tq in range(4):
                    for i in range(4):
                        shift = np.uint64(4 * tq + 16 * r + i)
                        out[32 * ks + 16 * r + 4 * tq + i] = (x >> shift) & 1
        return out

    w1 = [b_rows(0)]
    if t.boundary is not None:
        assert t.g1_frags.shape[1] == 6
        words = np.arange(nw)
        is_w = literal._is_word_char(torch.from_numpy(b)).numpy()
        rows = []
        for off in np.frombuffer(t.boundary, np.int8):
            if off == -128:
                rows.append(np.zeros(nw))
            else:
                pos = 4 * words + off
                rows.append(np.where(pos >= 0, is_w[pos.clip(0)], 0).astype(np.float64))
        w1.append(np.stack(rows))
        w1.append(np.zeros((16, nw)))  # features 48..63: zero in B and in G
    else:
        assert t.g1_frags.shape[1] == 4
    rows_info = t.rows.numpy()
    lo = 16 * t.long_tile0
    # every 8-row group holds one phase; the short section, then the long one
    assert (rows_info[:, 2].reshape(-1, 8) == rows_info[::8, 2:3]).all()
    real = rows_info[:, 0] != 1
    assert (rows_info[:lo, 3][real[:lo]] <= mxu.MAX_LEN).all()
    assert (rows_info[lo:, 3][real[lo:]] > mxu.MAX_LEN).all()
    hit = untile(t.g1_frags) @ np.concatenate(w1) == rows_info[:, :1]
    if t.g2_frags is not None:
        assert t.g2_frags.shape[:2] == (t.g1_frags.shape[0] - t.long_tile0, 4)
        hit[lo:] &= untile(t.g2_frags) @ b_rows(4) == rows_info[lo:, 1:2]
    flags = np.zeros((4, nw), bool)
    for p in range(4):
        flags[p] = hit[rows_info[:, 2] == p].any(0)
    return hit.sum(0), flags


LONGS = tuple(p for p in mixed_set(200, 3) if len(p) > mxu.MAX_LEN)
LAYOUT_SETS = {
    **SETS_C,
    # kp_s = 8: the reference's row tile 0 holds 8 short and 8 long rows
    "kp_s-8-mod-16": variants(5) + LONGS[:28],
    # kp_s = 24, kp_l = 8: its row tiles 1, 3, ... mix short and long rows
    "short-long-share-tile": variants(20) + LONGS[:6],
}


@pytest.mark.parametrize("ww", [False, True], ids=["plain", "w"])
@pytest.mark.parametrize("name", list(LAYOUT_SETS))
def test_kernel_operands_reproduce_plain(name, ww):
    """The CUDA kernel's operands, used the way the kernel uses them, give
    the plain version's counts and mask; on the sets whose reference row
    order mixes short and long rows in a 16-row tile, the kernel's does
    not."""
    patterns = LAYOUT_SETS[name]
    text = naive.gen_english(14, 3000) + b"\n".join(patterns) + b" x"
    for cs in (True, False):
        tst = dispatch.stage(text if cs else text.upper(), CPU)
        tables = mxu.device_tables(mxu.build_tables(patterns, cs, ww), CPU)
        if name not in SETS_C:
            assert tables.kp_s % 16 == 8
            lens = tables.lens.numpy().reshape(-1, 16)
            short, long_ = lens <= mxu.MAX_LEN, (lens > mxu.MAX_LEN) & (lens < 1 << 20)
            assert (short.any(1) & long_.any(1)).any()
        per_word, flags = kernel_layout_scan(tst.u8, tst.n_blocks, tables, cs)
        counts, mask = mxu.hamming_scan_plain(
            tst.u8, tst.n_blocks, tables, case_sensitive=cs, want_mask=True
        )
        assert per_word.sum() == int(counts.sum()) > 0
        assert np.array_equal(flags.T.reshape(-1), mask.numpy().astype(bool))


def test_hamming_plain_chunks_and_blocks(monkeypatch):
    """Chunks of 1000 words over three 64 KiB blocks: per-block counts and
    the mask do not depend on the chunking."""
    patterns = mixed_set(36, 9)
    text = naive.gen_english(15, 150_000)
    tst = dispatch.stage(text, CPU)
    tables = mxu.device_tables(mxu.build_tables(patterns, True, True), CPU)
    whole = mxu.hamming_scan_plain(tst.u8, tst.n_blocks, tables, want_mask=True)
    monkeypatch.setattr(mxu, "PLAIN_CHUNK_WORDS", 1000)
    parts = mxu.hamming_scan_plain(tst.u8, tst.n_blocks, tables, want_mask=True)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
    per = [naive.all_starts(text, p, True, True) for p in patterns]
    starts = np.concatenate([np.asarray(x, np.int64) for x in per])
    blocks = np.bincount(starts // 65536, minlength=tst.n_blocks)
    assert whole[0].tolist() == blocks.tolist()


# ------------------------------------------- kernel C: want_lines and strict

# tests/test_mxu.py:350-403, the texts cut to one 64 KiB block (interpret
# mode compiles a smaller grid step there): (text, patterns, cs, -w)
_LINES_TEXT_W = naive.gen_corpus(13, 60_000, alphabet=b"The fox_y\ndog THE cat")
_CARRY_TEXT = bytearray(b" " * (384 * 1024))
_CARRY_TEXT[100:103] = _CARRY_TEXT[200_000:200_003] = _CARRY_TEXT[300_010:300_013] = b"cat"
_CARRY_TEXT[300_000] = 0x0A
_TWO_WINDOW_TEXT = naive.gen_corpus(17, 60_000, alphabet=b"the quick brown fox\n")
LINE_CASES = {
    "naive": (naive.gen_corpus(11, 60_000, alphabet=b"the fox\ndog cat qx"),
              (b"the", b"fox", b"dog c", b"qx"), True, False),
    "i-w": (_LINES_TEXT_W, (b"the", b"fox", b"cat"), False, True),
    "carry-across-blocks": (bytes(_CARRY_TEXT), (b"cat", b"dogx"), True, False),
    "two-window": (_TWO_WINDOW_TEXT, (b"quick", _TWO_WINDOW_TEXT[50:72], b"fox"), True, False),
    "nl-start": (b"a\nb\na\nccc\n" * 40,
                 tuple(dict.fromkeys([b"\na", b"ccc"] + [b"z%02d" % i for i in range(34)])),
                 True, False),
}


@pytest.mark.parametrize("name", list(LINE_CASES))
def test_hamming_lines_match_mxu_want_lines(name):
    """The Hamming kernel's line mode (plain version) against
    mxu_multi.scan_count(want_lines=True), the chained route (the union mask
    into the lines kernel) and naive."""
    text, patterns, cs, ww = LINE_CASES[name]
    jst, tst = stage_both(text)
    c, l = mxu_multi.scan_count(
        jst.u32, jst.true_len, patterns=patterns, case_sensitive=cs, whole_word=ww,
        want_lines=True, interpret=True,
    )
    total, nlines, counts = mxu.scan_count(
        tst, patterns=patterns, case_sensitive=cs, whole_word=ww, want_lines=True
    )
    assert [int(total), int(nlines)] == [int(c), int(l)]
    assert int(nlines) == naive.matched_lines(text, union_starts(text, patterns, cs, ww))
    tables = mxu.device_tables(mxu.build_tables(patterns, cs, ww), CPU)
    stats, none = mxu.hamming_scan(tst.u8, tst.n_blocks, tables, case_sensitive=cs,
                                   want_lines=True)
    chained, mask = mxu.hamming_scan(tst.u8, tst.n_blocks, tables, case_sensitive=cs,
                                     want_mask=True)
    assert none is None and torch.equal(stats[:, 0], chained) and torch.equal(counts, chained)
    assert torch.equal(stats[:, 1:], swar.lines_blocks(tst.u8, mask, tst.n_blocks)[0][:, 1:])
    with pytest.raises(ValueError):
        mxu.hamming_scan(tst.u8, tst.n_blocks, tables, want_lines=True, want_mask=True)


def test_hamming_strict_garbage_tail():
    """tests/test_mxu.py:278-287: strict reads no word flag at or past
    true_len, so a match ending at true_len stays word-bounded."""
    text = b"the cat sat" + b"Z" * 50
    jst = jdispatch.stage(text)
    c = mxu_multi.scan_count(jst.u32, np.int32(11), patterns=(b"cat", b"sat"),
                             whole_word=True, strict=True, interpret=True)
    tst = convert.staged_from_reference(jst._np, len(text), CPU, true_len=11)
    kw = dict(patterns=(b"cat", b"sat"), whole_word=True)
    assert int(mxu.scan_count(tst, strict=True, **kw)[0]) == int(c) == 2
    assert int(mxu.scan_count(tst, **kw)[0]) == 1  # "satZ": the tail is read without strict


STRICT_SET = variants(30) + (b"the quick brown fox ju", b"e\0x", b"Holmes")


def strict_text() -> bytes:
    """A block of text with STRICT_SET's members planted at and across
    the true_len of every view below (n - j for j in STRICT_VIEWS)."""
    t = bytearray(naive.gen_english(19, 60_000))
    n = len(t)
    for j in (0, 1, 17, 4095):
        t[n - j - 6 : n - j] = b"Holmes"                                # ends at n - j
        t[n - j - 11 : n - j + 11] = b"the quick brown fox ju"[: 22]     # crosses n - j
        t[n - j - 40 : n - j - 37] = b"e\0x"
    return bytes(t)


STRICT_VIEWS = [(1, False), (4095, True)]


@pytest.mark.parametrize("j,ww", STRICT_VIEWS)
def test_hamming_strict_matches_mxu_on_with_len_views(j, ww):
    """strict on with_len(n - j) views whose tail holds live text, with a
    NUL member: the count and mask of mxu_multi.scan_count(strict=True) and
    of naive over the first n - j bytes."""
    text = strict_text()
    jst = jdispatch.stage(text)
    jv = jst.with_len(len(text) - j)
    c, mk = mxu_multi.scan_count(jv.u32, jv.true_len, patterns=STRICT_SET, whole_word=ww,
                                 strict=True, want_mask=True, interpret=True)
    tv = convert.staged_from_reference(jst._np, len(text), CPU, true_len=jv.n)
    total, mask, _ = mxu.scan_count(tv, patterns=STRICT_SET, whole_word=ww, strict=True,
                                    want_mask=True)
    head = text[: jv.n]
    want = sum(len(naive.all_starts(head, p, True, ww)) for p in STRICT_SET)
    assert int(total) == int(c) == want
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    assert torch.nonzero(mask).squeeze(1).tolist() == union_starts(head, STRICT_SET, True, ww)
    if j:
        with pytest.raises(ValueError):  # a NUL member needs strict
            mxu.scan_count(tv, patterns=STRICT_SET)


def test_fused_count_device_strict_on_a_view():
    """fused_count_device(strict=True) over a with_len view: the Hamming
    route bounds its starts, the fused route needs no flag."""
    text = strict_text()
    view = dispatch.stage(text, CPU).with_len(len(text) - 17)
    head = text[: view.n]
    for pats in (variants(40), variants(20)):
        want = sum(len(naive.all_starts(head, p)) for p in pats)
        assert multi.fused_count_device(view, pats, True, False, strict=True) == want


def test_inkernel_lines_route(monkeypatch):
    """KREP_TPU_MXU_LINES=inkernel: a Hamming-eligible set of at most 256
    patterns over a zero-tail text counts its lines in the Hamming kernel;
    a with_len view without tail_zero, or K > 256, takes the chained route;
    both routes count the same lines."""
    calls = []
    real = mxu.hamming_scan
    monkeypatch.setattr(mxu, "hamming_scan", lambda *a, **k: calls.append(
        k.get("want_lines", False)) or real(*a, **k))
    st = dispatch.stage(TEXT, CPU)
    pats = mixed_set(40, 3)
    chained = multi.fused_lines_device(st, pats, True, False)
    assert calls == [False]
    monkeypatch.setenv("KREP_TPU_MXU_LINES", "inkernel")
    calls.clear()
    assert multi.fused_lines_device(st, pats, True, False) == chained
    assert calls == [True]
    calls.clear()
    multi.fused_lines_device(st.with_len(st.n), pats, True, False)
    multi.fused_lines_device(st, variants(257), True, False)
    assert True not in calls
    assert multi.fused_lines_device(st.with_len(st.n, tail_zero=True), pats, True, False) == chained


# ---------------------------------------------------------------- kernel B

@pytest.mark.parametrize("patterns", [(b"\nthe", b"fox", b"e\n"), (b"fox", b"e\n", b"the")])
def test_lines_block_stats_matches_lines_from_mask(patterns):
    """With a pattern that starts with '\\n' (flags on newline bytes) the
    Pallas kernel is held with nl_start_matches on, as its caller sets it;
    without one, no flag sits on a newline and both settings agree."""
    text = naive.gen_english(16, 70_000)
    jst, tst = stage_both(text)
    _, mask = literal.block_stats_multi(
        tst.u8, tst.true_len, tst.n_blocks, patterns=patterns, want_mask=True
    )
    nl = torch.from_numpy(np.frombuffer(text, np.uint8) == 10)
    nl_start = any(p[:1] == b"\n" for p in patterns)
    assert bool(mask[: len(text)][nl].any()) == nl_start
    want = {
        int(pallas_swar.lines_from_mask(
            jst.u32, mask.numpy().view(np.uint32), jst.true_len,
            nl_start_matches=flag, interpret=True,
        ))
        for flag in ({True} if nl_start else {False, True})
    }
    assert len(want) == 1
    want = want.pop()
    stats, totals = swar.lines_blocks(tst.u8, mask, tst.n_blocks)
    assert torch.equal(stats, literal.lines_block_stats(tst.u8, mask, tst.n_blocks))
    assert torch.equal(totals, swar.combine_blocks(stats))
    got = int(totals[1])
    assert got == want == naive.matched_lines(text, torch.nonzero(mask).squeeze(1).tolist())


# ------------------------------------------------------- search and CLI

def same(a, b):
    assert (a.count, a.text_len) == (b.count, b.text_len)
    assert a.positions.tolist() == b.positions.tolist()


TEXT = naive.gen_english(17, 100_000) + b"\n" + b"the quick brown fox jumps over lazy dog " * 3

ROUTES = {
    "K3": (b"the", b"fox", b"Sherlock"),
    "K16": variants(16),
    "K40-hamming": mixed_set(40, 3),
    "K70-grouped-hamming": variants(70),
    "K70-grouped-fused": variants(69) + (b"x" * 40,),
    "long-member": (b"the", b"quick brown", b"the quick brown fox jumps over lazy dog " * 2),
    "slabs": (b"the", b"e\nthe", b"Holmes"),
}
MODES = {
    "c": dict(count_mode=True),
    "c-o": dict(count_mode=True, only_matching=True),
    "o": dict(only_matching=True),
    "m": dict(max_count=7, only_matching=True),
    "i": dict(case_sensitive=False, only_matching=True),
    "w": dict(whole_word=True, only_matching=True),
    "i-w-c": dict(case_sensitive=False, whole_word=True, count_mode=True),
    "m-c": dict(max_count=5, count_mode=True),
}


def route_of(name, monkeypatch):
    if name == "slabs":
        monkeypatch.setattr(search_mod, "SLAB_BYTES", 40_000)  # three slabs
    return ROUTES[name]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(ROUTES))
def test_search_string_matches_krep_tpu_host_route(name, mode, monkeypatch):
    """Every route x mode against krep_tpu's native host route (the
    reference that chip_smoke.py uses on the card)."""
    patterns = route_of(name, monkeypatch)
    p = SearchParams(patterns=patterns, **MODES[mode])
    got = search_string(p, TEXT, device="cpu")
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", REF_HOST)
    same(got, krep_tpu.search_string(jax_params(p), TEXT, threads=1))


@pytest.mark.parametrize("name", list(ROUTES))
def test_search_string_matches_krep_tpu_device_route(name, monkeypatch):
    """Each route against krep_tpu's own device route (as its tests run
    it here), in the modes where the routes differ most."""
    patterns = route_of(name, monkeypatch)
    for mode in ("c", "o"):
        p = SearchParams(patterns=patterns, **MODES[mode])
        same(search_string(p, TEXT, device="cpu"), krep_tpu.search_string(jax_params(p), TEXT, threads=1))


def test_routes_reach_their_kernels_plain_versions(monkeypatch):
    """Which kernel each route runs: K=40 on the Hamming products, its -c
    through the lines kernel; K<=31 on the fused pass."""
    calls = []
    for mod, name in ((mxu, "hamming_scan"), (swar, "scan_blocks_multi"),
                      (swar, "lines_blocks")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    search_string(SearchParams(patterns=ROUTES["K40-hamming"], count_mode=True), TEXT, device="cpu")
    assert calls == ["hamming_scan", "lines_blocks"]
    calls.clear()
    search_string(SearchParams(patterns=ROUTES["K16"], only_matching=True), TEXT, device="cpu")
    assert calls == ["scan_blocks_multi"]
    calls.clear()
    search_string(SearchParams(patterns=variants(31) + (b"\0x", b"\0y"), count_mode=True,
                               only_matching=True), TEXT, device="cpu")
    assert calls == ["scan_blocks_multi"]  # a NUL keeps K=33 off the Hamming route


def test_grouped_count_stops_at_max_count(monkeypatch):
    """-c -o -m over K > 64 fused groups stops launching once the cap is
    reached."""
    patterns = ROUTES["K70-grouped-fused"]
    assert not multi._mxu_eligible(patterns)
    calls = []
    real = dispatch.scan_multi_staged
    monkeypatch.setattr(dispatch, "scan_multi_staged",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    p = SearchParams(patterns=patterns, count_mode=True, only_matching=True, max_count=10)
    assert search_string(p, TEXT, device="cpu").count == 10
    assert len(calls) == 1  # the first group of 64 reached the cap


def test_multi_gpu_route_shards(monkeypatch):
    """With two CUDA devices, search_multi takes the sharded route
    (mesh.sharded_scan), here over two CPU shards through the mesh seam,
    and equals krep_tpu, which shards over its virtual devices."""
    from krep_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mesh, "devices", lambda device: (CPU, CPU))
    calls = []
    real = mesh.sharded_scan
    monkeypatch.setattr(mesh, "sharded_scan", lambda *a, **k: calls.append(k["mesh"]) or real(*a, **k))
    patterns = (b"the", b"fox", b"he q")
    for mode in ("o", "c"):
        p = SearchParams(patterns=patterns, **MODES[mode])
        got = multi.search_multi(p, TEXT, patterns, torch.device("cuda", 0))
        same(got, krep_tpu.search_string(jax_params(p), TEXT))
    assert calls == [(CPU, CPU)] * 2


def run(main, argv, stdin=b"", **kw):
    out = io.BytesIO()
    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    try:
        rc = main(list(argv), out=out, **kw)
    finally:
        sys.stdin = old
    return out.getvalue(), rc


CLI_ARGSETS = [
    ["-e", "the", "-e", "fox", "-o"],
    ["-e", "the", "-e", "fox", "-c"],
    ["--regexp", "the", "-e", "fox", "-c"],
    ["-e", "the", "-e", "Sherlock", "-e", "dog"],
    ["-w", "-i", "-o", "-e", "THE", "-e", "fox"],
    ["-m", "4", "-o", "-e", "the", "-e", "he"],
    ["-f", "PATFILE"],
    ["-c", "-o", "-f", "PATFILE"],
    ["-f", "-", "-c"],
]


@pytest.mark.parametrize("args", CLI_ARGSETS, ids=lambda a: " ".join(a))
def test_cli_matches_krep_tpu(args, tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(naive.gen_english(18, 30_000))
    patfile = tmp_path / "pats.txt"
    patfile.write_bytes(b"\n".join(variants(20)) + b"\n")
    argv = [str(patfile) if a == "PATFILE" else a for a in args] + [str(corpus)]
    stdin = patfile.read_bytes() if "-" in args else b""
    got = run(cli.main, argv, stdin, device="cpu")
    assert got[1] == 0
    assert got == run(jcli.main, argv, stdin)


INKERNEL_ARGSETS = [["-c", "-f", "PATFILE"], ["-w", "-c", "-f", "PATFILE"],
                    ["-i", "-c", "-f", "PATFILE"]]


@pytest.mark.parametrize("args", INKERNEL_ARGSETS, ids=lambda a: " ".join(a))
def test_cli_inkernel_lines_matches_krep_tpu(args, tmp_path, monkeypatch):
    """The port's CLI under KREP_TPU_MXU_LINES=inkernel (the Hamming
    kernel's line mode) against krep_tpu.cli on its default route."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(naive.gen_english(18, 30_000))
    patfile = tmp_path / "pats.txt"
    patfile.write_bytes(b"\n".join(mixed_set(40, 7)) + b"\n")
    argv = [str(patfile) if a == "PATFILE" else a for a in args] + [str(corpus)]
    calls = []
    real = mxu.hamming_scan
    monkeypatch.setattr(mxu, "hamming_scan", lambda *a, **k: calls.append(
        k.get("want_lines")) or real(*a, **k))
    monkeypatch.setenv("KREP_TPU_MXU_LINES", "inkernel")
    got = run(cli.main, argv, device="cpu")
    monkeypatch.delenv("KREP_TPU_MXU_LINES")
    assert calls == [True]
    assert got[1] == 0 and got == run(jcli.main, argv)
