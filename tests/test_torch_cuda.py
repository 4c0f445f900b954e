"""krep_tpu_torch's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card; every test skips without one. The module imports no
jax, so it also runs where jax is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import naive
from krep_tpu_torch import SearchParams, search_string
from krep_tpu_torch.engine import search as search_mod
from krep_tpu_torch.ops import ac, bytescan, dispatch, literal, multi, mxu, swar
from krep_tpu_torch.parallel import lines
from krep_tpu_torch.tools import bench_hamming, bench_multi


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def kernels_vs_plain(st, **kw):
    """The scan and its tail on a staged text against their plain versions,
    exactly, in one launch (no combine_blocks launch); returns the kernel's
    start mask (or None)."""
    before = (swar.LAUNCHES, swar.TAIL_FOLDS, swar.COMBINE_LAUNCHES)
    stats, mask, tot = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
    assert (swar.LAUNCHES, swar.TAIL_FOLDS, swar.COMBINE_LAUNCHES) == (before[0] + 1,
                                                                       before[1] + 1, before[2])
    pstats, pmask = literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw)
    assert torch.equal(stats, pstats)
    assert (mask is None) == (pmask is None)
    if mask is not None:
        assert torch.equal(mask, pmask)
    assert torch.equal(tot, lines.combine_block_stats(pstats))
    return mask


@pytest.mark.cuda
def test_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(4)
    for size in (1, 65536, 300_000):
        text = naive.gen_corpus(size, size, alphabet=b"abcAB_^ \n\nthe\xc1\xe1[@`{")
        st = dispatch.stage(text, cuda_device)
        for pat in (b"a", b"the", b"\nthe", b"e\n", b"_^", text[:64]):
            for cs, ww in [(True, False), (False, True)]:
                for prev, limit in [(0, None), (1, int(rng.integers(1, size + 1)))]:
                    mask = kernels_vs_plain(
                        st, pattern=pat, case_sensitive=cs, whole_word=ww,
                        prev_word=prev, start_limit=limit, want_mask=True,
                    )
                    if limit is None:
                        want = naive.all_starts(text, pat, cs, ww)
                        assert torch.nonzero(mask).squeeze(1).tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("want_mask", [False, True], ids=["count", "mask"])
def test_kernels_match_plain_over_1024_blocks(cuda_device, want_mask):
    """The early-exit slab shape of the slab loop (64 MiB owned plus the
    pattern's halo: a 1536-block bucket), where the scan tail folds more
    than one summary per thread."""
    owned = 64 << 20
    unit = np.frombuffer(naive.gen_english(17, 1 << 20), np.uint8)
    text = np.tile(unit, owned // unit.shape[0] + 1)[: owned + 3]
    for pat, cs, ww, prev in [(b"the", True, False, 0), (b"THE", False, True, 1)]:
        st = dispatch.stage(text, cuda_device, true_len=owned + len(pat) - 1)
        assert st.n_blocks == 1536
        kernels_vs_plain(
            st, pattern=pat, case_sensitive=cs, whole_word=ww, prev_word=prev,
            start_limit=owned - 12_345, want_mask=want_mask,
        )


def random_summaries(rng, n: int) -> np.ndarray:
    """(n, 8) int32 block summaries that real text could give: a block
    without a newline has trail == lead == (count > 0)."""
    rows = np.zeros((n, 8), np.int32)
    rows[:, 0] = rng.integers(0, 50, n) * (rng.random(n) < 0.6)
    any_match = rows[:, 0] > 0
    rows[:, 1] = np.minimum(rows[:, 0], rng.integers(1, 20, n))
    has_nl = rng.random(n) < 0.7
    rows[:, 2] = np.where(has_nl, any_match & (rng.random(n) < 0.5), any_match)
    rows[:, 3] = np.where(has_nl, any_match & (rng.random(n) < 0.5), any_match)
    rows[:, 4] = has_nl
    return rows


@pytest.mark.cuda
def test_combine_kernel_on_random_summaries(cuda_device):
    """Block counts from 1 to past the 1 GiB and 1.5 GiB buckets (16,384
    and 24,576 blocks): one to many summaries per combine thread."""
    rng = np.random.default_rng(6)
    for n in (1, 2, 1023, 1024, 1025, 1536, 16_384, 24_576, 24_577):
        stats = torch.from_numpy(random_summaries(rng, n)).to(cuda_device)
        assert torch.equal(swar.combine_blocks(stats), lines.combine_block_stats(stats)), n


MODES = [
    dict(count_mode=True),
    dict(only_matching=True),
    dict(),
    dict(max_count=3, only_matching=True),
    dict(case_sensitive=False, whole_word=True, count_mode=True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", MODES, ids=lambda kw: ",".join(kw) or "lines")
def test_search_on_card_matches_cpu(cuda_device, kw, monkeypatch):
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    text = naive.gen_english(31, 400_000)
    p = SearchParams(patterns=(b"the",), **kw)
    want = search_string(p, text, device="cpu")
    got = search_string(p, text, device=cuda_device)
    assert (got.count, got.positions.tolist()) == (want.count, want.positions.tolist())
    monkeypatch.setattr(search_mod, "SLAB_BYTES", 100_000)  # four slabs
    got = search_string(p, text, device=cuda_device)
    assert (got.count, got.positions.tolist()) == (want.count, want.positions.tolist())


def edge_text(seed: int, size: int) -> bytes:
    """Random bytes of a small alphabet with "the", "_the", "THE x" planted
    across every 64 KiB block edge and some 1 KiB Hamming tile edges."""
    text = bytearray(naive.gen_corpus(seed, size, b"abcthe THE_^9\n\n"))
    for edge in list(range(65536, size - 8, 65536)) + list(range(1024, size - 8, 7 * 1024)):
        text[edge - 2 : edge + 3] = b"the x"
        text[edge + 4 : edge + 8] = b"_THE"  # -w before-byte right before
    text[65535:65537] = b"_t"  # a -w before-byte in the previous block
    return bytes(text)


MULTI_SETS = [
    (b"the",),
    (b"the", b"he x", b"\nt"),
    tuple(b"t%02d" % i for i in range(61)) + (b"the", b"x_th", b"abcthe THE_^9the the x_THEab"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("patterns", MULTI_SETS, ids=["K1", "K3", "K64"])
def test_multi_kernels_match_plain(cuda_device, patterns):
    """The K-pattern scan, the lines kernel and the Hamming kernel against
    their plain versions, exactly, over five blocks; the Hamming kernel's
    block counts and union mask also equal the K-pattern scan's."""
    text = edge_text(5, 300_000)
    st = dispatch.stage(text, cuda_device)
    for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
        before = (swar.MULTI_LAUNCHES, swar.LINES_LAUNCHES, mxu.LAUNCHES)
        kw = dict(patterns=patterns, case_sensitive=cs, whole_word=ww, want_mask=True)
        stats, mask, totals = swar.scan_blocks_multi(st.u8, st.true_len, st.n_blocks, **kw)
        pstats, pmask = literal.block_stats_multi(st.u8, st.true_len, st.n_blocks, **kw)
        assert torch.equal(stats, pstats) and torch.equal(mask, pmask)
        assert torch.equal(totals, lines.combine_block_stats(pstats))
        want = sorted({s for p in patterns for s in naive.all_starts(text, p, cs, ww)})
        assert torch.nonzero(mask).squeeze(1).tolist() == want
        lstats, ltotals = swar.lines_blocks(st.u8, mask, st.n_blocks)
        assert torch.equal(lstats, literal.lines_block_stats(st.u8, mask, st.n_blocks))
        assert torch.equal(ltotals, lines.combine_block_stats(lstats))
        tables = mxu.device_tables(mxu.build_tables(patterns, cs, ww), cuda_device)
        counts, hmask = mxu.hamming_scan(
            st.u8, st.n_blocks, tables, case_sensitive=cs, want_mask=True
        )
        pcounts, phmask = mxu.hamming_scan_plain(
            st.u8, st.n_blocks, tables, case_sensitive=cs, want_mask=True
        )
        assert torch.equal(counts, pcounts) and torch.equal(hmask, phmask)
        assert torch.equal(counts, stats[:, 0]) and torch.equal(hmask, mask)
        assert (swar.MULTI_LAUNCHES, swar.LINES_LAUNCHES, mxu.LAUNCHES) == tuple(
            b + 1 for b in before
        )


@pytest.mark.cuda
def test_hamming_kernel_256_patterns_two_windows(cuda_device):
    """One full Hamming pass: 256 members of 1-29 bytes (both windows, all
    four boundary word shifts), with and without -w."""
    rng = np.random.default_rng(8)
    text = edge_text(9, 200_000)
    pats = {bytes(text[i : i + int(rng.integers(1, 30))]) for i in rng.integers(0, 190_000, 400)}
    patterns = tuple(sorted(p for p in pats if 0 not in p))[:256]
    st = dispatch.stage(text, cuda_device)
    for ww in (False, True):
        tables = mxu.device_tables(mxu.build_tables(patterns, False, ww), cuda_device)
        got = mxu.hamming_scan(st.u8, st.n_blocks, tables, case_sensitive=False,
                               want_mask=True)
        want = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, case_sensitive=False,
                                      want_mask=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def multi_edge_text(kind: str, patterns, size: int = 64 << 20) -> np.ndarray:
    """64 MiB (1,024 blocks) of the config-1 corpus (a match every few
    bytes) or a-z text (few), with members of `patterns` planted to start
    on the last byte of a block and of a thread's 256-byte span, on the
    first byte of a block, and at the text's end."""
    if kind == "corpus":
        text = bench_hamming.corpus(size)
    else:
        text = np.random.default_rng(3).integers(97, 123, size, dtype=np.uint8)
    rng = np.random.default_rng(4)
    for i, at in enumerate(list(range(65535, size - 100, 65536 * 7))
                           + list(range(65536 * 3 + 255, size - 100, 65536 * 5 + 256 * 3))
                           + list(range(65536 * 2, size - 100, 65536 * 11))):
        p = patterns[int(rng.integers(len(patterns)))]
        text[at : at + len(p)] = np.frombuffer(p, np.uint8)
    last = patterns[-1]
    text[size - len(last) :] = np.frombuffer(last, np.uint8)
    return text


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["corpus", "a-z"])
@pytest.mark.parametrize("name", ["16 literals", "common prefix", "collision"])
def test_multi_scan_instances_match_plain(cuda_device, kind, name):
    """Every template instance of the K-pattern scan (count and mask, -i,
    -w, the shard mode) against literal.block_stats_multi, exactly, over
    1,024 blocks: bench.py's 16 literals, 64 members that share one 4-byte
    prefix (one candidate, 64 items) and a set that collides in the
    filter map; members start on the last byte of blocks and of thread
    spans; the shard's start limit lies inside a thread's span."""
    patterns = {"16 literals": tuple(bench_hamming.PATTERNS_16),
                "common prefix": bench_multi.common_prefix_set(),
                "collision": bench_multi.collision_set()}[name]
    st = dispatch.stage(multi_edge_text(kind, patterns), cuda_device)
    assert st.n_blocks == 1024
    limit = st.n_blocks * 65536 - 12_345
    assert limit % 256 not in (0, 255)
    tl = limit + max(map(len, patterns)) - 1
    for _, cs, ww, want_mask, shard in bench_multi.instances():
        kw = dict(patterns=patterns, case_sensitive=cs, whole_word=ww, want_mask=want_mask,
                  prev_word=int(shard), start_limit=limit if shard else None)
        true_len = tl if shard else st.true_len
        before = (swar.MULTI_LAUNCHES, swar.MULTI_SHARD_LAUNCHES)
        stats, mask, totals = swar.scan_blocks_multi(st.u8, true_len, st.n_blocks, **kw)
        assert (swar.MULTI_LAUNCHES, swar.MULTI_SHARD_LAUNCHES) == (before[0] + 1,
                                                                    before[1] + int(shard))
        pstats, pmask = literal.block_stats_multi(st.u8, true_len, st.n_blocks, **kw)
        assert torch.equal(stats, pstats), (cs, ww, want_mask, shard)
        assert torch.equal(totals, lines.combine_block_stats(pstats)), (cs, ww, want_mask, shard)
        assert (mask is None) == (not want_mask)
        if want_mask:
            assert torch.equal(mask, pmask), (cs, ww, shard)
        if kind == "corpus" and not ww:
            assert int(stats[:, 0].sum()) > 100_000


MULTI_MODES = [
    dict(count_mode=True),
    dict(count_mode=True, only_matching=True),
    dict(only_matching=True),
    dict(max_count=9, only_matching=True),
    dict(case_sensitive=False, whole_word=True, count_mode=True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", MULTI_MODES, ids=lambda kw: ",".join(kw))
@pytest.mark.parametrize("k", [3, 40, 70])
def test_multi_search_on_card_matches_cpu(cuda_device, kw, k, monkeypatch):
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    text = naive.gen_english(32, 400_000)
    words = sorted(set(text.split()))
    patterns = tuple(words[:k]) if k <= len(words) else tuple(
        words + [w[:4] + b"%d" % i for i, w in enumerate(words * 3)][: k - len(words)]
    )
    p = SearchParams(patterns=patterns, **kw)
    want = search_string(p, text, device="cpu")
    got = search_string(p, text, device=cuda_device)
    assert (got.count, got.positions.tolist()) == (want.count, want.positions.tolist())


def line_mix_text(seed: int, size: int) -> bytes:
    """Lines of 1-1,500 bytes, of up to 40,000 and of three blocks and more:
    lines that cross the 256-byte thread spans and the 64 KiB block edges
    with matches on both sides, and blocks with no newline."""
    rng = np.random.default_rng(seed)
    words = [b"the", b"cat", b"theme", b"x", b"THE", b"_the", b"at", b"e", b"^"]
    out = bytearray()
    while len(out) < size:
        kind = int(rng.integers(0, 10))
        n = 3 * 65536 + 777 if kind == 0 else int(rng.integers(1, 1500 if kind < 8 else 40_000))
        line = bytearray()
        while len(line) < n:
            line += words[int(rng.integers(0, len(words)))] + b" "
        out += line[:n] + b"\n"
    return bytes(out[:size])


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 65536, 1_000_000])
def test_first_line_kernels_match_plain(cuda_device, size):
    """The scan kernel's first_line mode, one launch whose tail finishes
    the mask (no fix-up kernel is left), against
    literal.block_stats(mask_kind="first_line"), exactly, over lines that
    straddle thread spans and blocks; the flags are the first match of
    each line."""
    from krep_tpu_torch.ops import _build

    assert not hasattr(swar, "first_line_fixup") and not hasattr(swar, "FIXUP_LAUNCHES")
    assert not hasattr(_build.library(), "krep_first_line_fixup")
    text = line_mix_text(size, size)
    st = dispatch.stage(text, cuda_device)
    rng = np.random.default_rng(size)
    for pat in (b"e", b"the", b"\n", b"e\nt", text[100:117], text[1000:1064]):
        if len(pat) < 1:
            continue
        for cs, ww in [(True, False), (False, True)]:
            for prev, limit in [(0, None), (1, int(rng.integers(1, size + 1)))]:
                before = (swar.LAUNCHES, swar.FIRST_LINE_LAUNCHES, swar.TAIL_FOLDS)
                kw = dict(pattern=pat, case_sensitive=cs, whole_word=ww, prev_word=prev,
                          start_limit=limit, want_mask=True, mask_kind="first_line")
                stats, mask, totals = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
                assert (swar.LAUNCHES, swar.FIRST_LINE_LAUNCHES, swar.TAIL_FOLDS) == tuple(
                    b + 1 for b in before)  # one launch, its tail finishing the mask
                pstats, pmask = literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw)
                assert torch.equal(stats, pstats) and torch.equal(mask, pmask)
                assert torch.equal(totals, lines.combine_block_stats(pstats))
                if limit is None:
                    starts = np.array(naive.all_starts(text, pat, cs, ww), np.int64)
                    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 10)
                    line = np.searchsorted(nl, starts)  # a start on '\n' is in the line it ends
                    first = np.ones(len(starts), bool)
                    first[1:] = line[1:] != line[:-1]
                    assert torch.nonzero(mask).squeeze(1).tolist() == starts[first].tolist()


def first_line_launch(text, true_len, n_blocks, mode, pattern=b"the"):
    """One launch of the first_line instance through the library entry:
    mode 1 finishes the mask in the tail (as swar.scan_blocks), mode 2
    leaves each block's flags as if it began on a closed line."""
    from krep_tpu_torch.ops import _build

    stats = torch.empty((n_blocks, 8), dtype=torch.int32, device=text.device)
    mask = torch.empty(n_blocks * 65536, dtype=torch.uint8, device=text.device)
    totals = torch.empty(8, dtype=torch.int32, device=text.device)
    stream = torch.cuda.current_stream(text.device).cuda_stream
    err = _build.library().krep_scan_blocks(
        text.data_ptr(), n_blocks, pattern, len(pattern), 0, 0, true_len, 0, swar.NO_LIMIT, mode,
        mask.data_ptr(), stats.data_ptr(), totals.data_ptr(),
        swar.tail_scratch(text.device, stream).data_ptr(), stream)
    assert err == 0
    return stats, mask, totals


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [64, 65, 128, 1536])
def test_first_line_tail_fixup_at_group_edges(cuda_device, n_blocks):
    """The tail's fix-up at the edges of its 64-block groups: lines over
    many blocks (no newline in blocks 1-3 and in each block 63-66 and
    127-129 that exists), leads entering matched lines on both sides of
    each group edge. The one launch equals literal.block_stats'
    first_line mode; the launch without the step, finished by
    lines.first_line_fixup, equals it too; and every lead the step clears
    lies in a block that enters a matched line."""
    text = raw_text(n_blocks, seed=n_blocks)
    for b0, b1 in ((63, 67), (127, 130)):
        seg = text[b0 * 65536 : min(b1, n_blocks) * 65536]
        seg[seg == 10] = 32
    dtext = text.to(cuda_device)
    body = n_blocks * 65536
    kw = dict(pattern=b"the", want_mask=True, mask_kind="first_line")
    stats, mask, totals = swar.scan_blocks(dtext, body, n_blocks, **kw)
    pstats, pmask = literal.block_stats(dtext, body, n_blocks, **kw)
    check_totals(stats, totals, pstats, n_blocks)
    assert torch.equal(mask, pmask)
    bstats, blockwise, btotals = first_line_launch(dtext, body, n_blocks, 2)
    assert torch.equal(bstats, stats) and torch.equal(btotals, totals)
    cleared = torch.nonzero(blockwise != mask).squeeze(1)
    assert cleared.numel() > 0
    assert torch.equal(lines.first_line_fixup(stats, blockwise.clone()), mask)
    assert set(cleared.tolist()) <= set(stats[:, 5].tolist())  # only block leads
    again = first_line_launch(dtext, body, n_blocks, 1)
    assert torch.equal(again[1], mask) and torch.equal(again[2], totals)


@pytest.mark.cuda
@pytest.mark.parametrize("args", [["-r", "-c", "the"], ["-r", "-o", "the"],
                                  ["-r", "-i", "-w", "-c", "THE"], ["-r", "-e", "the", "-e", "cat"]],
                         ids=lambda a: " ".join(a))
def test_recursive_on_card_matches_cpu(cuda_device, tmp_path, args, monkeypatch):
    """-r through the batched scan and a solo file, on the card and on the
    CPU (the kernels' plain versions): identical output."""
    import io

    from krep_tpu_torch import cli
    from krep_tpu_torch.io import batch

    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    monkeypatch.setattr(batch, "BATCH_BUFFER_MAX", 200_000)
    for i in range(40):
        sub = tmp_path / f"d{i % 4}"
        sub.mkdir(exist_ok=True)
        (sub / f"f{i}.txt").write_bytes(line_mix_text(100 + i, 1000 * i))
    (tmp_path / "solo.txt").write_bytes(line_mix_text(7, batch.BATCH_FILE_MAX + 5000))
    outs = []
    for dev in (cuda_device, "cpu"):
        out = io.BytesIO()
        rc = cli.main([*args, str(tmp_path)], out=out, device=dev)
        outs.append((out.getvalue(), rc))
    assert outs[0] == outs[1] and outs[0][1] == 0


SHARD_LIMITS = [0, 2 * 65536 - 2, 2 * 65536 - 1, 299_995]  # "the" starts at 2 * 65536 - 2


@pytest.mark.cuda
@pytest.mark.parametrize("patterns", MULTI_SETS, ids=["K1", "K3", "K64"])
def test_shard_modes_match_plain(cuda_device, patterns):
    """The K-pattern scan's and the Hamming kernel's shard modes
    (start_limit, prev_word / prev_flag) against their plain versions,
    exactly: limits that cut a match at a block edge, an empty shard, and
    matches that end past the limit (true_len up to limit + m - 1)."""
    text = edge_text(5, 300_000)
    st = dispatch.stage(text, cuda_device)
    m_max = max(map(len, patterns))
    for limit in SHARD_LIMITS:
        tl = min(limit + m_max - 1, len(text))
        for cs, ww in [(True, False), (False, True)]:
            for prev in (0, 1):
                before = (swar.MULTI_SHARD_LAUNCHES, mxu.SHARD_LAUNCHES)
                kw = dict(patterns=patterns, case_sensitive=cs, whole_word=ww, prev_word=prev,
                          start_limit=limit, want_mask=True)
                stats, mask, totals = swar.scan_blocks_multi(st.u8, tl, st.n_blocks, **kw)
                pstats, pmask = literal.block_stats_multi(st.u8, tl, st.n_blocks, **kw)
                assert torch.equal(stats, pstats) and torch.equal(mask, pmask)
                assert torch.equal(totals, lines.combine_block_stats(pstats))
                assert not mask[limit:].any()
                tables = mxu.device_tables(mxu.build_tables(patterns, cs, ww), cuda_device)
                hk = dict(case_sensitive=cs, want_mask=True, start_limit=limit, prev_flag=prev)
                counts, hmask = mxu.hamming_scan(st.u8, st.n_blocks, tables, **hk)
                pcounts, phmask = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, **hk)
                assert torch.equal(counts, pcounts) and torch.equal(hmask, phmask)
                assert torch.equal(counts, stats[:, 0]) and torch.equal(hmask, mask)
                assert (swar.MULTI_SHARD_LAUNCHES, mxu.SHARD_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [3, 8])
def test_sharded_route_on_card_matches_cpu(cuda_device, n_shards):
    """parallel.mesh on a repeated-device mesh of the card against the same
    route on a CPU mesh (the kernels' plain versions): totals, lines and
    starts of one literal and of K=3, -w, and the Hamming count."""
    from krep_tpu_torch.parallel import mesh

    text = np.frombuffer(edge_text(11, 700_000), np.uint8)
    meshes = ((cuda_device,) * n_shards, (torch.device("cpu"),) * n_shards)
    for pats in [(b"the",), (b"the", b"he x", b"\nt")]:
        for ww in (False, True):
            got, want = (mesh.sharded_scan(text, pats, whole_word=ww, want_mask=True, mesh=m)
                         for m in meshes)
            assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist()
    pats = MULTI_SETS[2]
    for ww in (False, True):
        assert len({mesh.sharded_count(text, pats, whole_word=ww, mesh=m) for m in meshes}) == 1


@pytest.mark.cuda
def test_real_mesh_matches_one_card(cuda_device, monkeypatch, tmp_path):
    """On a machine with several cards the engine shards on its own: with
    -t unset over every card, with -t 2 over two, and each result equals
    -t 1 (one card) on every route: one literal, three literals, the
    Hamming count, K > 64 groups, a pattern over 64 bytes; and a -r walk
    whose solo file shards."""
    from krep_tpu_torch import cli
    from krep_tpu_torch.io import batch
    from krep_tpu_torch.parallel import mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs more than one CUDA device")
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    staged = []
    real = mesh.stage_shards
    monkeypatch.setattr(mesh, "stage_shards",
                        lambda data, m: staged.append(tuple(m)) or real(data, m))
    text = naive.gen_english(33, 3_000_000)
    words = sorted(set(text.split()))
    long_pat = text[1_000_000:1_000_080]
    for pats in [(b"the",), (b"the", b"fox", b"Holmes"), tuple(words[:40]),
                 tuple(words[:30]) + tuple(w + b"s" for w in words[:40]), (long_pat,)]:
        for kw in MULTI_MODES:
            p = SearchParams(patterns=pats, **kw)
            want = search_string(p, text, threads=1, device=cuda_device)
            for t in (None, 2):
                got = search_string(p, text, threads=t, device=cuda_device)
                assert (got.count, got.positions.tolist()) == (want.count, want.positions.tolist())
    assert {len(m) for m in staged} == {n_cards, 2}
    assert all(len(set(m)) == len(m) for m in staged)  # distinct cards
    (tmp_path / "solo.txt").write_bytes(text[: batch.BATCH_FILE_MAX + 70_000])
    (tmp_path / "small.txt").write_bytes(text[:5000])
    staged.clear()
    for args in (["-r", "-c", "the"], ["-r", "-o", "-e", "the", "-e", "fox"]):
        outs = []
        for t in ([], ["-t", "1"]):
            out = io.BytesIO()
            outs.append((cli.main([*t, *args, str(tmp_path)], out=out, device=cuda_device),
                         out.getvalue()))
        assert outs[0] == outs[1] and outs[0][0] == 0
    assert staged and {len(m) for m in staged} == {n_cards}


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 65536, 300_000])
def test_byte_scan_matches_plain(cuda_device, size):
    """The byte scan against its plain version, exactly: patterns of 1 to
    4096 bytes (cut from the text across block edges), -i, -w, with and
    without the mask, over texts of one to five blocks."""
    text = edge_text(size, max(size, 8))[:size]
    st = dispatch.stage(text, cuda_device)
    pats = [b"t", b"the", b"\nt", b"_THE", text[65530:65547], text[65000:65064],
            text[131000:131065], text[120_000:121_000], text[60_000:64_096]]
    for pat in (p for p in pats if p):
        for cs, ww in [(True, False), (False, True), (False, False), (True, True)]:
            for want_mask in (False, True):
                kw = dict(pattern=pat, case_sensitive=cs, whole_word=ww, want_mask=want_mask)
                before = (bytescan.LAUNCHES, bytescan.MASK_LAUNCHES)
                stats, mask, totals = bytescan.scan_blocks_bytes(st.u8, st.true_len,
                                                                 st.n_blocks, **kw)
                assert (bytescan.LAUNCHES, bytescan.MASK_LAUNCHES) == (before[0] + 1,
                                                                      before[1] + want_mask)
                pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len, st.n_blocks, **kw)
                assert torch.equal(stats, pstats)
                assert torch.equal(totals, lines.combine_block_stats(pstats))
                if want_mask:
                    assert torch.equal(mask, pmask)
                    want = naive.all_starts(text, pat, cs, ww)
                    assert torch.nonzero(mask).squeeze(1).tolist() == want


@pytest.mark.cuda
def test_byte_scan_variants_match_plain(cuda_device):
    """Each cost-attribution variant against its plain version, and the
    passthrough sum against torch.sum, over a text whose byte sum wraps
    int32."""
    rng = np.random.default_rng(0)
    text = rng.integers(97, 123, 24 << 20, dtype=np.uint8)
    text[::1000] = 10
    st = dispatch.stage(text, cuda_device)
    for mode in bytescan.VARIANTS:
        before = bytescan.VARIANT_LAUNCHES[mode]
        stats = bytescan.scan_variant(st.u8, st.true_len, st.n_blocks, mode=mode)
        assert bytescan.VARIANT_LAUNCHES[mode] == before + 1
        assert torch.equal(stats, bytescan.variant_stats_plain(st.u8, st.true_len, st.n_blocks,
                                                               mode=mode))
        got = bytescan.run_variant(st.u8, st.true_len, st.n_blocks, mode=mode).tolist()
        assert got == lines.combine_block_stats(stats)[:2].tolist()
    body = st.n_blocks * 65536
    total = int(text.astype(np.int64).sum())
    assert total > 2**31
    got = int(bytescan.run_variant(st.u8, st.true_len, st.n_blocks, mode="passthrough")[0])
    assert got == (total + 2**31) % 2**32 - 2**31 == int(torch.sum(st.u8[:body], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("patterns", MULTI_SETS, ids=["K1", "K3", "K64"])
def test_hamming_lines_and_strict_match_plain(cuda_device, patterns):
    """The Hamming kernel's line mode and strict mode against their plain
    versions, exactly: lines over five blocks with -i and -w and a
    '\n'-leading member; strict on with_len(n - j) views of a buffer with
    live text past true_len."""
    text = edge_text(5, 300_000)
    st = dispatch.stage(text, cuda_device)
    for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
        tables = mxu.device_tables(mxu.build_tables(patterns, cs, ww), cuda_device)
        before = (mxu.LAUNCHES, mxu.LINES_LAUNCHES)
        stats, none = mxu.hamming_scan(st.u8, st.n_blocks, tables, case_sensitive=cs,
                                       want_lines=True)
        assert none is None and (mxu.LAUNCHES, mxu.LINES_LAUNCHES) == (before[0] + 1,
                                                                      before[1] + 1)
        pstats, _ = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, case_sensitive=cs,
                                           want_lines=True)
        assert torch.equal(stats, pstats)
        for j in (0, 1, 17, 4095):
            view = st.with_len(len(text) - j)
            kw = dict(case_sensitive=cs, want_mask=True, strict=True, true_len=view.true_len)
            before = mxu.STRICT_LAUNCHES
            counts, mask = mxu.hamming_scan(view.u8, view.n_blocks, tables, **kw)
            assert mxu.STRICT_LAUNCHES == before + 1
            pcounts, pmask = mxu.hamming_scan_plain(view.u8, view.n_blocks, tables, **kw)
            assert torch.equal(counts, pcounts) and torch.equal(mask, pmask)
            if j == 17:
                head = text[: view.n]
                want = sorted({s for p in patterns for s in naive.all_starts(head, p, cs, ww)})
                assert torch.nonzero(mask).squeeze(1).tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("kw", MODES, ids=lambda kw: ",".join(kw) or "lines")
def test_knobs_on_card_match_cpu(cuda_device, kw, monkeypatch):
    """KREP_TPU_BACKEND=pallas (one literal) and KREP_TPU_MXU_LINES=inkernel
    (40 patterns) on the card against the CPU."""
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    monkeypatch.setenv("KREP_TPU_BACKEND", "pallas")
    monkeypatch.setenv("KREP_TPU_MXU_LINES", "inkernel")
    text = naive.gen_english(34, 400_000)
    words = sorted(set(text.split()))
    for pats in ((b"the",), tuple((words + [w + b"x" for w in words])[:40])):
        p = SearchParams(patterns=pats, **kw)
        want = search_string(p, text, device="cpu")
        got = search_string(p, text, device=cuda_device)
        assert (got.count, got.positions.tolist()) == (want.count, want.positions.tolist())


def hamming_boundary_sets() -> dict:
    """Pattern sets at the Hamming kernel's layout boundaries, cut from
    edge_text(13, ...) so they match: one window (K = 32, and K = 33 whose
    kp_s = 40 is 8 mod 16), two windows with kp_s = 24 and 8 (the reference
    row order mixes short and long rows in a 16-row tile), K = 64, and a
    full 256-member pass (G too large for shared memory: read from global
    memory)."""
    rng = np.random.default_rng(12)
    text = edge_text(13, 300_000)

    def cut(lo, hi, k):
        out = []
        for i in rng.integers(0, 290_000, 50 * k):
            p = text[int(i) : int(i) + int(rng.integers(lo, hi + 1))]
            if p not in out:
                out.append(p)
            if len(out) == k:
                return tuple(out)
        raise AssertionError("too few distinct members")

    return {
        "K32": cut(3, 8, 32),
        "K33": cut(3, 13, 33),
        "K40-kp24": cut(3, 13, 20) + cut(14, 29, 20),
        "K33-kp8": cut(1, 13, 5) + cut(14, 29, 28),
        "K64": cut(4, 13, 32) + cut(14, 20, 32),
        "K256": cut(1, 13, 128) + cut(14, 29, 128),
    }


HAMMING_SETS = ["K32", "K33", "K40-kp24", "K33-kp8", "K64", "K256"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", HAMMING_SETS)
def test_hamming_modes_on_layout_boundaries(cuda_device, name):
    """Every mode of the Hamming kernel against hamming_scan_plain, exactly,
    on the boundary sets, with and without -i and -w: count and mask;
    want_lines; strict on with_len(n - j) views of a buffer with live text
    past true_len; start_limit at offsets inside a tile with prev_flag 0
    and 1."""
    patterns = hamming_boundary_sets()[name]
    text = bytearray(edge_text(13, 300_000))
    for at in (1024 * 7 - 5, 65536 - 9, 65536 * 3 + 1019):  # members across tile edges
        text[at : at + len(patterns[-1])] = patterns[-1]
    text = bytes(text)
    st = dispatch.stage(text, cuda_device)
    for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
        tables = mxu.device_tables(mxu.build_tables(patterns, cs, ww), cuda_device)
        cases = [dict(want_mask=True), dict(want_lines=True)]
        cases += [dict(want_mask=True, strict=True, true_len=len(text) - j)
                  for j in (0, 1, 17, 4095)]
        cases += [dict(want_mask=True, start_limit=lim, prev_flag=prev)
                  for lim in (1, 2 * 65536 + 1003, len(text) - 5) for prev in (0, 1)]
        for kw in cases:
            u8, n_blocks = st.u8, st.n_blocks
            if kw.get("strict"):
                view = st.with_len(kw["true_len"])
                u8, n_blocks = view.u8, view.n_blocks
            got = mxu.hamming_scan(u8, n_blocks, tables, case_sensitive=cs, **kw)
            want = mxu.hamming_scan_plain(u8, n_blocks, tables, case_sensitive=cs, **kw)
            assert torch.equal(got[0], want[0]), (cs, ww, kw)
            assert (got[1] is None) == (want[1] is None)
            if got[1] is not None:
                assert torch.equal(got[1], want[1]), (cs, ww, kw)
        counts, _ = mxu.hamming_scan(st.u8, st.n_blocks, tables, case_sensitive=cs)
        assert int(counts.sum()) == sum(len(naive.all_starts(text, p, cs, ww)) for p in patterns)


# ------------------------------------------------ the word scan (both kernels)

WORD_EDGES = (16 * 7 - 1, 16 * 11 - 2, 512 - 1, 512 * 5 - 3, 8192 - 1, 8192 * 3 - 2,
              65536 - 1, 65536 - 2)


def word_edge_text(kind: str, patterns, size: int = 64 << 20) -> np.ndarray:
    """64 MiB of the config-1 corpus (a match every few bytes) or of a-z
    (few), with each of `patterns` planted across lane (16 B), stride
    (512 B), warp (8 KiB) and block edges of several blocks, after "_^",
    and to end at the text's end; some lines run over three blocks."""
    if kind == "corpus":
        text = bench_hamming.corpus(size)
    else:
        text = np.random.default_rng(3).integers(97, 123, size, dtype=np.uint8)
        text[::4099] = 10
    rng = np.random.default_rng(8)
    for at in rng.integers(0, size - 300_000, 6):  # long lines: no newline for 3-4 blocks
        seg = text[at : at + int(rng.integers(200_000, 300_000))]
        seg[seg == 10] = 32
    for i, p in enumerate(patterns):
        arr = np.frombuffer(p, np.uint8)
        for b in range(1 + 7 * i, size // 65536 - 1, 97):
            for e in WORD_EDGES:
                at = b * 65536 + e
                text[at : at + len(arr)] = arr
        at = 65536 * (5 + 3 * i) + 777
        text[at : at + len(arr) + 2] = np.frombuffer(b"_^" + p, np.uint8)
    last = np.frombuffer(patterns[-1], np.uint8)
    text[size - len(last) :] = last
    return text


def word_scan_patterns(text: np.ndarray) -> dict:
    """Patterns of 1..64 bytes: short words, and longer ones cut from the
    text at a line start."""
    nl = int(np.flatnonzero(text[3000:] == 10)[2]) + 3001
    return {m: {1: b"e", 3: b"the", 5: b"quick"}.get(m) or bytes(text[nl : nl + m])
            for m in (1, 3, 5, 9, 17, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["corpus", "a-z"])
def test_k1_word_scan_instances_match_plain(cuda_device, kind):
    """Every instance of the K=1 scan (length class <= 4, <= 8, > 8; -w;
    no mask, start mask, first_line) and its shard mode (start_limit inside
    a lane's 16 bytes, prev_word 0 and 1), with and without -i, against
    literal.block_stats, exactly, at 64 MiB."""
    pats = word_scan_patterns(bench_hamming.corpus(1 << 16))
    text = word_edge_text(kind, tuple(pats.values()))
    st = dispatch.stage(text, cuda_device)
    assert st.n_blocks == 1024
    limit = st.n_blocks * 65536 - 12_345
    assert limit % 16 not in (0, 15)
    for m, pat in pats.items():
        found = 0
        for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
            p = pat if cs else pat.upper()
            for kw in (dict(), dict(want_mask=True), dict(want_mask=True, mask_kind="first_line"),
                       dict(prev_word=1, start_limit=limit, want_mask=True),
                       dict(prev_word=0, start_limit=limit)):
                kw.update(pattern=p, case_sensitive=cs, whole_word=ww)
                tl = limit + m - 1 if "start_limit" in kw else st.true_len
                before = (swar.LAUNCHES, swar.MASK_LAUNCHES, swar.SHARD_LAUNCHES)
                stats, mask, totals = swar.scan_blocks(st.u8, tl, st.n_blocks, **kw)
                starts = kw.get("want_mask") and kw.get("mask_kind") != "first_line"
                assert (swar.LAUNCHES, swar.MASK_LAUNCHES, swar.SHARD_LAUNCHES) == (
                    before[0] + 1, before[1] + bool(starts), before[2] + ("start_limit" in kw))
                pstats, pmask = literal.block_stats(st.u8, tl, st.n_blocks, **kw)
                assert torch.equal(stats, pstats), (m, cs, ww, kw)
                assert torch.equal(totals, lines.combine_block_stats(pstats)), (m, cs, ww, kw)
                if mask is not None or pmask is not None:
                    assert torch.equal(mask, pmask), (m, cs, ww, kw)
                found += int(stats[:, 0].sum())
        assert found > 0, m  # the plants matched


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["corpus", "a-z"])
def test_byte_word_scan_instances_match_plain(cuda_device, kind):
    """Every scan instance of the byte scan (the three length classes, -w,
    with and without the mask), with and without -i, for patterns of 1 to
    4096 bytes, and the four variants, against their plain versions,
    exactly, at 64 MiB."""
    src = bench_hamming.corpus(1 << 16)
    nl = int(np.flatnonzero(src[3000:] == 10)[2]) + 3001
    pats = {m: {1: b"t", 3: b"the", 5: b"quick"}.get(m) or bytes(src[nl : nl + m])
            for m in (1, 3, 5, 9, 17, 65, 1000)}
    pats[4096] = bytes(np.resize(src[nl:], 4096))
    text = word_edge_text(kind, tuple(pats.values()))
    st = dispatch.stage(text, cuda_device)
    for m, pat in pats.items():
        got = None
        for cs, ww in [(True, False), (False, False), (True, True), (False, True)]:
            p = pat if cs else pat.upper()
            for want_mask in (False, True):
                kw = dict(pattern=p, case_sensitive=cs, whole_word=ww, want_mask=want_mask)
                stats, mask, totals = bytescan.scan_blocks_bytes(st.u8, st.true_len,
                                                                 st.n_blocks, **kw)
                pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len, st.n_blocks, **kw)
                assert torch.equal(stats, pstats), (m, cs, ww, want_mask)
                assert torch.equal(totals, lines.combine_block_stats(pstats))
                if want_mask:
                    assert torch.equal(mask, pmask), (m, cs, ww)
                got = got if got is not None else int(stats[:, 0].sum())
        assert got > 0, m  # the plants matched
    for mode in bytescan.VARIANTS:
        for pat in (b"the", pats[17], pats[1000]):
            got = bytescan.scan_variant(st.u8, st.true_len, st.n_blocks, mode=mode, pattern=pat)
            want = bytescan.variant_stats_plain(st.u8, st.true_len, st.n_blocks, mode=mode,
                                                pattern=pat)
            assert torch.equal(got, want), (mode, len(pat))


@pytest.mark.cuda
def test_word_scan_dense_candidates_match_plain(cuda_device):
    """Runs of one byte and patterns whose 4-byte prefix repeats: every
    position of a run passes the filter, so every warp's verify queue is
    full; both kernels, exactly."""
    size = 16 << 20
    text = np.full(size, ord("a"), np.uint8)
    rng = np.random.default_rng(2)
    text[rng.integers(0, size, size // 3000)] = ord("b")
    text[rng.integers(0, size, size // 5000)] = 10
    st = dispatch.stage(text, cuda_device)
    for pat in (b"aaaab", b"a" * 8 + b"b", b"a" * 16 + b"b", b"a" * 63 + b"b", b"a" * 64):
        for kw in (dict(), dict(want_mask=True), dict(want_mask=True, mask_kind="first_line"),
                   dict(whole_word=True, want_mask=True)):
            stats, mask, totals = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, pattern=pat,
                                                   **kw)
            pstats, pmask = literal.block_stats(st.u8, st.true_len, st.n_blocks, pattern=pat, **kw)
            assert torch.equal(stats, pstats) and (mask is None or torch.equal(mask, pmask))
            assert torch.equal(totals, lines.combine_block_stats(pstats))
            if not kw:
                assert int(stats[:, 0].sum()) > 0, pat  # runs of "a" hold every one
    for pat in (b"a" * 64 + b"b", b"a" * 999 + b"b", b"a" * 16):
        kw = dict(pattern=pat, want_mask=True)
        stats, mask, totals = bytescan.scan_blocks_bytes(st.u8, st.true_len, st.n_blocks, **kw)
        pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len, st.n_blocks, **kw)
        assert torch.equal(stats, pstats) and torch.equal(mask, pmask), len(pat)
        assert torch.equal(totals, lines.combine_block_stats(pstats))


@pytest.mark.cuda
def test_first_line_word_scan_long_lines(cuda_device):
    """first_line on 64 MiB of lines that span lanes, warps and three or
    more blocks (line_mix_text's 8 MiB, eight times), against its plain
    version, exactly; the flags are the first match of each line."""
    text = np.tile(np.frombuffer(line_mix_text(5, 8 << 20), np.uint8), 8)
    st = dispatch.stage(text, cuda_device)
    gaps = np.diff(np.flatnonzero(text == 10))
    assert int(gaps.max()) > 3 * 65536
    for pat, cs, ww in ((b"e", True, False), (b"the", False, True), (b"theme", True, False),
                        (b"the cat x the cat", True, False)):
        kw = dict(pattern=pat, case_sensitive=cs, whole_word=ww, want_mask=True,
                  mask_kind="first_line")
        stats, mask, totals = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
        pstats, pmask = literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw)
        assert torch.equal(stats, pstats) and torch.equal(mask, pmask), pat
        assert torch.equal(totals, lines.combine_block_stats(pstats)), pat
        assert int(mask.sum()) == int(totals[1])


# ------------------------------------- the scan tail and the lines kernel

TAIL_BLOCKS = [1, 2, 257, 1536]


def raw_text(n_blocks: int, seed: int = 9) -> torch.Tensor:
    """n_blocks * 64 KiB of the config-1 corpus and a 4 KiB zero halo, flat
    on the CPU: any block count, not only the staging buckets. Lines of
    three blocks and more (no newline in them) start at block 1."""
    body = n_blocks * 65536
    buf = np.zeros(body + dispatch.HALO_BYTES, np.uint8)
    buf[:body] = np.resize(bench_hamming.corpus(1 << 21, seed), body)
    if n_blocks > 4:
        seg = buf[65536 + 100 : 4 * 65536 + 900]
        seg[seg == 10] = 32
    return torch.from_numpy(buf)


def tail_limits(n_blocks: int) -> list[int]:
    """Start limits that leave blocks with no owned byte: 0, and one a
    third of the way into the text (blocks past it write zeros)."""
    return sorted({0, max(0, (n_blocks - 1) // 3 * 65536 - 5)})


def check_totals(stats: torch.Tensor, totals: torch.Tensor, pstats: torch.Tensor, what) -> None:
    assert torch.equal(stats, pstats), what
    assert torch.equal(totals, lines.combine_block_stats(stats)), what


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", TAIL_BLOCKS)
def test_scan_tail_totals_match_plain(cuda_device, n_blocks):
    """Every family of launches that folds its own totals (the K=1 count,
    start mask, first_line and shard instances; the byte scan; the
    K-pattern count, mask and shard instances; the lines kernel) returns
    totals equal to lines.combine_block_stats of its rows, with
    combine_blocks never launched: at 1, 2, 257 and 1,536 blocks and at
    start limits that leave blocks with no owned byte."""
    text = raw_text(n_blocks).to(cuda_device)
    body = n_blocks * 65536
    before = (swar.COMBINE_LAUNCHES, swar.TAIL_FOLDS)
    n = 0
    for kw in (dict(), dict(want_mask=True), dict(want_mask=True, mask_kind="first_line"),
               dict(case_sensitive=False, whole_word=True)):
        stats, _, totals = swar.scan_blocks(text, body, n_blocks, pattern=b"the", **kw)
        pstats, _ = literal.block_stats(text, body, n_blocks, pattern=b"the", **kw)
        check_totals(stats, totals, pstats, ("K=1", kw))
        n += 1
    for want_mask in (False, True):
        stats, _, totals = bytescan.scan_blocks_bytes(text, body, n_blocks, pattern=b"quick",
                                                      want_mask=want_mask)
        pstats, _ = bytescan.block_stats_bytes(text, body, n_blocks, pattern=b"quick",
                                               want_mask=want_mask)
        check_totals(stats, totals, pstats, ("byte scan", want_mask))
        n += 1
    pats = tuple(bench_hamming.PATTERNS_16)
    for want_mask in (False, True):
        stats, mask, totals = swar.scan_blocks_multi(text, body, n_blocks, patterns=pats,
                                                     want_mask=want_mask)
        pstats, _ = literal.block_stats_multi(text, body, n_blocks, patterns=pats,
                                              want_mask=want_mask)
        check_totals(stats, totals, pstats, ("K=16", want_mask))
        n += 1
    lstats, ltotals = swar.lines_blocks(text, mask, n_blocks)
    check_totals(lstats, ltotals, literal.lines_block_stats(text, mask, n_blocks), "lines")
    n += 1
    for limit in tail_limits(n_blocks):
        for prev, want_mask in ((0, False), (1, True)):
            kw = dict(prev_word=prev, start_limit=limit, want_mask=want_mask)
            stats, _, totals = swar.scan_blocks(text, limit + 2, n_blocks, pattern=b"the", **kw)
            pstats, _ = literal.block_stats(text, limit + 2, n_blocks, pattern=b"the", **kw)
            check_totals(stats, totals, pstats, ("K=1 shard", limit, prev))
            tl = limit + max(map(len, pats)) - 1
            stats, _, totals = swar.scan_blocks_multi(text, tl, n_blocks, patterns=pats, **kw)
            pstats, _ = literal.block_stats_multi(text, tl, n_blocks, patterns=pats, **kw)
            check_totals(stats, totals, pstats, ("K=16 shard", limit, prev))
            n += 2
    assert (swar.COMBINE_LAUNCHES, swar.TAIL_FOLDS) == (before[0], before[1] + n)


@pytest.mark.cuda
def test_scan_tail_back_to_back(cuda_device):
    """Launches of every tail-carrying kernel back to back on one stream
    (one scratch), at other block counts, none synchronised before the
    last: each launch's totals equal the fold of its own rows."""
    runs = []
    for n_blocks in (257, 1, 1536, 2, 257):
        text = raw_text(n_blocks, seed=n_blocks).to(cuda_device)
        body = n_blocks * 65536
        limit = tail_limits(n_blocks)[-1]
        stats, mask, totals = swar.scan_blocks_multi(text, body, n_blocks,
                                                     patterns=(b"the", b"fox"), want_mask=True)
        runs.append((stats, totals))
        runs.append(swar.lines_blocks(text, mask, n_blocks))
        runs.append(swar.scan_blocks(text, limit + 2, n_blocks, pattern=b"the", start_limit=limit,
                                     want_mask=True)[::2])
        runs.append(bytescan.scan_blocks_bytes(text, body, n_blocks, pattern=b"e")[::2])
        runs.append(swar.scan_blocks(text, body, n_blocks, pattern=b"the", want_mask=True,
                                     mask_kind="first_line")[::2])
    torch.cuda.synchronize()
    for i, (stats, totals) in enumerate(runs):
        assert torch.equal(totals, lines.combine_block_stats(stats)), i
    scratch = swar.tail_scratch(cuda_device, torch.cuda.current_stream().cuda_stream)
    assert not scratch[512 * 8 :].any()  # every counter back at zero


@pytest.mark.cuda
def test_scan_tail_two_streams(cuda_device):
    """Two host threads, each launching on a stream of its own at the same
    time (two scratches): every launch's totals equal the fold of its own
    rows."""
    import threading

    texts = [raw_text(1536, seed=3).to(cuda_device), raw_text(257, seed=4).to(cuda_device)]
    torch.cuda.synchronize()
    results: list[list] = [[], []]
    errors = []

    def work(i: int) -> None:
        try:
            stream = torch.cuda.Stream(cuda_device)
            text, n_blocks = texts[i], texts[i].shape[0] // 65536
            body = n_blocks * 65536
            with torch.cuda.stream(stream):
                for r in range(12):
                    pat = (b"the", b"fox", b"e", b"quick")[r % 4]
                    if i == 0:
                        out = swar.scan_blocks(text, body, n_blocks, pattern=pat)
                    else:
                        out = swar.scan_blocks_multi(text, body, n_blocks, patterns=(pat, b"dog"))
                    results[i].append((out[0], out[2]))
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in (0, 1):
        assert len(results[i]) == 12
        for stats, totals in results[i]:
            assert torch.equal(totals, lines.combine_block_stats(stats)), i


def lines_edge_mask(text: np.ndarray, seed: int) -> np.ndarray:
    """A 0/1 start mask over `text`: sparse random flags, flags on newline
    bytes, and flags on both sides of lane (16 B), stride (512 B), warp
    (8 KiB) and block edges; zero in the second half of each odd block."""
    rng = np.random.default_rng(seed)
    mask = (rng.random(text.shape[0]) < 0.003).astype(np.uint8)
    nl = np.flatnonzero(text == 10)
    mask[nl[::7]] = 1
    for e in WORD_EDGES:
        for b in range(0, text.shape[0] // 65536):
            for at in (b * 65536 + e, b * 65536 + e + 1):
                if at < text.shape[0]:
                    mask[at] = 1
    for b in range(1, text.shape[0] // 65536, 2):
        mask[b * 65536 + 32768 : (b + 1) * 65536] = 0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 3, 257])
def test_lines_kernel_edge_cases(cuda_device, n_blocks):
    """The lines kernel against literal.lines_block_stats, exactly: flags on
    newline bytes, lines across lane, stride, warp and block edges, blocks
    with no newline (a line over three blocks), an all-zero mask; its
    totals equal the fold of its rows."""
    text = raw_text(n_blocks, seed=n_blocks)
    body = n_blocks * 65536
    if n_blocks >= 3:  # no newline in blocks 1-2
        text[65536 : 3 * 65536][text[65536 : 3 * 65536] == 10] = 32
    masks = [lines_edge_mask(text[:body].numpy(), n_blocks), np.zeros(body, np.uint8)]
    dtext = text.to(cuda_device)
    for mask in masks:
        dmask = torch.from_numpy(mask).to(cuda_device)
        before = swar.LINES_LAUNCHES
        stats, totals = swar.lines_blocks(dtext, dmask, n_blocks)
        assert swar.LINES_LAUNCHES == before + 1
        check_totals(stats, totals, literal.lines_block_stats(dtext, dmask, n_blocks),
                     int(mask.sum()))
        starts = np.flatnonzero(mask).tolist()
        assert int(totals[1]) == naive.matched_lines(text[:body].numpy().tobytes(), starts)


def dfa_vs_plain(text: bytes, pats, cs: bool, device, kinds=ac.TABLE_KINDS,
                 spans=(None,)) -> tuple[int, int]:
    """ops/ac.py's dfa_walk (csrc/dfa_scan.cu) on `device` against its
    plain version (dfa_scan_plain over krep_tpu's lanes, on the CPU) on the
    same staged text, exactly: the count and mask instances of every table
    kind in `kinds` that holds the set, at each span (None: lane_span's);
    returns (total, flagged ends)."""
    table, emit = ac.build_dense_ac(list(pats), cs)
    maxlen = max(map(len, pats))
    st, cst = dispatch.stage(text, device), dispatch.stage(text, "cpu")
    kw = dict(maxlen=maxlen, case_sensitive=cs)
    ptotal, pmask = ac.dfa_walk(cst.u8, cst.n, cst.n_blocks, torch.from_numpy(table),
                                torch.from_numpy(emit), want_mask=True, **kw)
    dtable, demit = torch.from_numpy(table).to(device), torch.from_numpy(emit).to(device)
    ran = []
    for kind in kinds:
        try:
            packed = ac.pack_dense_table(table, emit, cs, kind).to(device)
        except ValueError:  # this kind cannot hold the set
            continue
        for span in spans:
            before = (ac.LAUNCHES, ac.MASK_LAUNCHES, ac.KIND_LAUNCHES[kind])
            total, mask = ac.dfa_walk(st.u8, st.n, st.n_blocks, dtable, demit, want_mask=True,
                                      packed=packed, span=span, **kw)
            ctotal, none = ac.dfa_walk(st.u8, st.n, st.n_blocks, dtable, demit,
                                       want_mask=False, packed=packed, span=span, **kw)
            torch.cuda.synchronize()
            assert (ac.LAUNCHES, ac.MASK_LAUNCHES, ac.KIND_LAUNCHES[kind]) == (
                before[0] + 2, before[1] + 1, before[2] + 2)
            assert int(total) == int(ctotal) == int(ptotal) and none is None, (kind, span)
            assert torch.equal(mask.cpu(), pmask), (kind, span)
        ran.append(kind)
    assert ran
    # the wrapper's own packing picks the first kind that holds the set
    total, mask = ac.dfa_walk(st.u8, st.n, st.n_blocks, dtable, demit, want_mask=True, **kw)
    assert int(total) == int(ptotal) and torch.equal(mask.cpu(), pmask)
    return int(total), int(pmask.sum())


@pytest.mark.cuda
def test_dfa_scan_matches_plain(cuda_device):
    """The dense-DFA kernel, every table kind that holds each set: texts of
    1 byte to 3 MiB (spans straddling the text's end, whole spans past it),
    -i, a 64-byte member, members that start with zero bytes (the halo
    before the text reads as zeros), 100 of bench.py's variants (the shared
    table) and 300 (past it: global), at the default span and at 16, 384
    and 5,376 bytes (the last span past the body)."""
    corpus = naive.gen_english(23, 3 << 20)
    upper = bytes(np.where(np.frombuffer(corpus, np.uint8) % 7 == 0,
                           np.frombuffer(corpus.upper(), np.uint8), np.frombuffer(corpus, np.uint8)))
    sets = [bench_hamming.variant_set(100), bench_hamming.variant_set(300),
            (b"the", b"he", b"e", corpus[1000:1064], b"\x00\x00t", b"\x00T", b"her")]
    for pats in sets:
        for size in (1, 100, 65_536 + 7, 1 << 20, 3 << 20):
            for cs in (True, False):
                spans = (None, 16, 384, 5376) if size == 1 << 20 else (None,)
                total, ends = dfa_vs_plain(upper[:size], pats, cs, cuda_device, spans=spans)
                if size >= 65_536:
                    assert total >= ends > 0


@pytest.mark.cuda
def test_dfa_scan_wide_counts(cuda_device):
    """A -f list whose emission count passes 16 bits (65,600 copies of
    "the" beside 100 variants) takes the wide table (counts from emit[])
    by default, exactly; the other kinds refuse it."""
    pats = (b"the",) * 65_600 + bench_hamming.variant_set(100)
    table, emit = ac.build_dense_ac(list(pats), True)
    assert int(emit.max()) > 0xFFFF
    assert ac.pack_dense_table(table, emit, True).kind == "wide"
    text = naive.gen_english(29, 1 << 20)
    for cs in (True, False):
        before = ac.KIND_LAUNCHES["wide"]
        total, ends = dfa_vs_plain(text, pats, cs, cuda_device, kinds=("wide",),
                                   spans=(None, 64))
        assert total > 0xFFFF and ac.KIND_LAUNCHES["wide"] == before + 5


@pytest.mark.cuda
def test_soak_on_the_card(cuda_device):
    """tools/soak_fuzz_torch.py for 20 s on the card: every batch through
    the port's CUDA kernels against krep_tpu's native host route, clean."""
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "tools" / "soak_fuzz_torch.py"), "--seconds", "20",
         "--seed-base", "11"], cwd=repo, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "soak clean" in proc.stdout
