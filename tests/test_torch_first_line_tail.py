"""The first-line fix-up in the scan tail (csrc/scan_common.cuh
finish_blocks' kLeads, clear_entering_leads) on the CPU.

A numpy model of the tail's steps: the group rows' line-state maps
scanned two groups a thread over 256 threads (warp scans by shuffle, then
the warps in order), then each warp taking whole groups of 64 rows, two
rows a lane, scanned from its group's entering state; a block's lead flag
(stats word 5) is cleared where its entering line already has a match. It
is held to lines.first_line_fixup (the plain twin) on random rows at block
counts around the 64-block group edges and at the tail's 512-group limit,
and, on real block rows, to the whole text's first-in-line flags; and the
port's first_line scan (its plain version on the CPU) to krep_tpu's
pallas_swar.scan_literal(mask_kind="first_line") in interpret mode.
"""

import numpy as np
import pytest
import torch

import naive
from krep_tpu.ops import dispatch as jdispatch
from krep_tpu.ops import pallas_swar
from krep_tpu_torch import convert
from krep_tpu_torch.ops import literal, swar
from krep_tpu_torch.parallel import lines

CPU = torch.device("cpu")
BLOCK = literal.BLOCK_BYTES
GROUP = 64          # scan_common.cuh kGroupBlocks
THREADS = 256       # scan_common.cuh kThreads
PASS, SET = 1, 2    # scan_common.cuh kPass, kSet


def map_then(x, y):
    return (x & (y | (y << 1)) & 3) | (y & SET)


def map_apply(m, s):
    return ((s & m) | (m >> 1)) & 1


def row_maps(rows: np.ndarray) -> np.ndarray:
    return np.where(rows[:, 4] != 0, 0, PASS) | np.where(rows[:, 2] != 0, SET, 0)


def warp_scan(v: np.ndarray):
    """warp_scan_maps over the last axis (32 lanes): (inclusive, exclusive)."""
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        u = np.concatenate([v[..., :d], v[..., :-d]], axis=-1)  # __shfl_up_sync: lanes < d keep
        v = np.where(lane >= d, map_then(u, v), v)
    ex = np.concatenate([np.full(v.shape[:-1] + (1,), PASS), v[..., :-1]], axis=-1)
    return v, ex


def model_tail_fixup(stats: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """clear_entering_leads on (n, 8) rows and a flat mask, in numpy."""
    mask = mask.copy()
    n = stats.shape[0]
    ngroups = -(-n // GROUP)
    assert ngroups <= 2 * THREADS
    group_rows = np.stack([lines.combine_block_stats(torch.from_numpy(
        stats[g * GROUP : (g + 1) * GROUP])).numpy() for g in range(ngroups)])
    gm = np.full(2 * THREADS, PASS)
    gm[:ngroups] = row_maps(group_rows)
    inc, ex = warp_scan(map_then(gm[0::2], gm[1::2]).reshape(THREADS // 32, 32))
    pre = np.full(THREADS // 32, PASS)
    for w in range(1, THREADS // 32):
        pre[w] = map_then(pre[w - 1], inc[w - 1, 31])
    s0 = map_apply(map_then(pre[:, None], ex), 0).reshape(-1)
    group_in = np.zeros(2 * THREADS, np.int64)
    group_in[0::2], group_in[1::2] = s0, map_apply(gm[0::2], s0)
    for g in range(ngroups):  # warp g % 8, in any order: groups are independent now
        r0 = g * GROUP + 2 * np.arange(32)
        x = [np.where(r < n, row_maps(stats[np.minimum(r, n - 1)]), PASS) for r in (r0, r0 + 1)]
        _, ex = warp_scan(map_then(x[0], x[1]))
        s = map_apply(ex, group_in[g])
        for k, r in enumerate((r0, r0 + 1)):
            ok = r < n
            lead = stats[np.minimum(r, n - 1), 5]
            mask[lead[ok & (s == 1) & (lead >= 0)]] = 0
            s = map_apply(x[k], s)
    return mask


@pytest.mark.parametrize("n_blocks", [1, 63, 64, 65, 130, 1536, 32768])
def test_tail_model_matches_plain_fixup(n_blocks):
    """Random rows (trails, newlines, lead offsets, runs of blocks with no
    newline): the model clears exactly what lines.first_line_fixup does."""
    rng = np.random.default_rng(n_blocks)
    stats = np.zeros((n_blocks, 8), np.int32)
    stats[:, 2] = rng.random(n_blocks) < 0.4
    stats[:, 4] = rng.random(n_blocks) < np.where(np.arange(n_blocks) % 97 < 40, 0.05, 0.6)
    has_lead = rng.random(n_blocks) < 0.7
    stats[:, 5] = np.where(has_lead, np.arange(n_blocks) * 8 + rng.integers(0, 8, n_blocks), -1)
    mask = (rng.random(n_blocks * 8) < 0.3).astype(np.uint8)
    mask[stats[has_lead, 5]] = 1
    want = lines.first_line_fixup(torch.from_numpy(stats), torch.from_numpy(mask.copy())).numpy()
    got = model_tail_fixup(stats, mask)
    assert np.array_equal(got, want)
    if n_blocks >= 64:
        assert (got != mask).sum() > n_blocks // 10  # plenty of leads cleared


def edge_text(n_blocks: int) -> bytes:
    """Lines of "ab cd" with one line from block 0 to block 3 (no newline
    in blocks 1 and 2), "the" on both sides of each block edge and inside
    the long line."""
    text = bytearray(b"ab cd\n" * (n_blocks * BLOCK // 6))
    text[BLOCK - 4000 : 3 * BLOCK + 3000] = b"x" * (2 * BLOCK + 7000)
    for pos in (96, BLOCK - 3000, BLOCK - 3, BLOCK + 5, 2 * BLOCK - 2, 2 * BLOCK + 2000,
                3 * BLOCK + 1000, 3 * BLOCK + 4000, 4 * BLOCK - 1, 4 * BLOCK + 100):
        if pos + 3 <= len(text):
            text[pos : pos + 3] = b"the"
    return bytes(text)


def test_first_line_scan_matches_pallas_interpret():
    """The port's first_line scan on a 4-block text (its plain version on
    the CPU) against pallas_swar's first_line mode in interpret mode; the
    model applied to the scan's rows and each block's own first-in-line
    flags gives the same mask."""
    text = edge_text(4)
    jst = jdispatch.stage(text)
    st = convert.staged_from_reference(jst._np, len(text), CPU)
    stats, mask, totals = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, pattern=b"the",
                                           want_mask=True, mask_kind="first_line")
    c, l, jmask = pallas_swar.scan_literal(
        jst.u32, jst.true_len, pattern=b"the", want_mask=True, want_lines=True,
        mask_kind="first_line", interpret=True,
    )
    jmask = np.asarray(jmask).view(np.uint8)
    assert np.array_equal(mask.numpy(), jmask[: mask.shape[0]])
    assert totals[:2].tolist() == [int(c), int(l)]
    starts = naive.all_starts(text, b"the", True, False)
    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 10)
    line = np.searchsorted(nl, starts)
    first = [s for i, s in enumerate(starts) if i == 0 or line[i] != line[i - 1]]
    assert torch.nonzero(mask).squeeze(1).tolist() == first
    _, starts_mask, _ = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, pattern=b"the",
                                         want_mask=True)
    per_block = torch.cat([
        literal.first_in_line_mask(starts_mask[b * BLOCK : (b + 1) * BLOCK].bool(),
                                   st.u8[b * BLOCK : (b + 1) * BLOCK]).to(torch.uint8)
        for b in range(st.n_blocks)
    ]).numpy()
    assert (per_block != mask.numpy()).sum() == 3  # blocks 1-3 enter the long matched line
    assert np.array_equal(model_tail_fixup(stats.numpy(), per_block), mask.numpy())
