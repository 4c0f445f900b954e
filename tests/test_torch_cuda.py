"""krep_tpu_torch's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card; every test skips without one. The module imports no
jax, so it also runs where jax is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import naive
from krep_tpu_torch import SearchParams, search_string
from krep_tpu_torch.engine import search as search_mod
from krep_tpu_torch.ops import dispatch, literal, mxu, swar
from krep_tpu_torch.parallel import lines


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def kernels_vs_plain(st, **kw):
    """Both kernels on a staged text against their plain versions, exactly;
    returns the kernel's start mask (or None)."""
    before = (swar.LAUNCHES, swar.COMBINE_LAUNCHES)
    stats, mask = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
    tot = swar.combine_blocks(stats)
    assert (swar.LAUNCHES, swar.COMBINE_LAUNCHES) == (before[0] + 1, before[1] + 1)
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
    pattern's halo: a 1536-block bucket), where the combine kernel folds
    more than one summary per thread."""
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
        stats, mask = swar.scan_blocks_multi(st.u8, st.true_len, st.n_blocks, **kw)
        pstats, pmask = literal.block_stats_multi(st.u8, st.true_len, st.n_blocks, **kw)
        assert torch.equal(stats, pstats) and torch.equal(mask, pmask)
        want = sorted({s for p in patterns for s in naive.all_starts(text, p, cs, ww)})
        assert torch.nonzero(mask).squeeze(1).tolist() == want
        lstats = swar.lines_blocks(st.u8, mask, st.n_blocks)
        assert torch.equal(lstats, literal.lines_block_stats(st.u8, mask, st.n_blocks))
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
