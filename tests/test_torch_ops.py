"""krep_tpu_torch ops against the JAX package, on the same staged bytes.

The port's plain PyTorch scan (ops/literal.py) and the CPU route of its
kernel wrappers (ops/swar.py: the plain twins of the CUDA kernels) are held
to pallas_swar's kernel in interpret mode, to the JAX package's
literal.py, and to tests/naive.py. Every output is an integer or a byte,
so every comparison is exact equality.

tests/test_torch_cuda.py holds the same comparisons for the CUDA kernels.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import naive
from test_torch_cuda import random_summaries
from krep_tpu.ops import dispatch as jdispatch
from krep_tpu.ops import literal as jliteral
from krep_tpu.ops import pallas_swar
from krep_tpu.parallel import mesh
from krep_tpu_torch import convert
from krep_tpu_torch.ops import dispatch, literal, swar
from krep_tpu_torch.parallel import lines
from krep_tpu_torch.utils import profiling

CPU = torch.device("cpu")


def stage_both(text: bytes):
    jst = jdispatch.stage(text)
    return jst, convert.staged_from_reference(jst._np, len(text), CPU)


def port_scan(tst, pat, cs=True, ww=False):
    """(count, lines, body mask) from the port's plain scan_literal, after
    checking that the kernel route (block stats + ordered combine) agrees."""
    c, l, mk = literal.scan_literal(
        tst.u8, tst.true_len, pattern=pat, case_sensitive=cs, whole_word=ww
    )
    tot, mask, group_counts = dispatch.scan_literal_staged(
        tst, pattern=pat, case_sensitive=cs, whole_word=ww, want_mask=True,
    )
    body = mask.shape[0]
    assert tot[:2].tolist() == [c, l]
    assert torch.equal(mask, mk[:body])
    assert not mk[body:].any()
    assert group_counts.sum().item() == c
    return c, l, mask.numpy()


def pallas_scan(jst, pat, cs=True, ww=False):
    c, l, mk = pallas_swar.scan_literal(
        jst.u32, jst.true_len, pattern=pat, case_sensitive=cs,
        whole_word=ww, want_mask=True, interpret=True,
    )
    return int(c), int(l), np.asarray(mk).view(np.uint8)


def xla_scan(jst, pat, cs=True, ww=False):
    c, l, mk = jliteral.scan_literal(
        jst.u8, jst.true_len, pattern=pat, case_sensitive=cs, whole_word=ww,
    )
    return int(c), int(l), np.asarray(mk)


def assert_same(got, want):
    c, l, mk = got
    wc, wl, wmk = want
    assert (c, l) == (wc, wl)
    n = min(len(mk), len(wmk))
    assert np.array_equal(mk[:n], wmk[:n])
    assert not mk[n:].any() and not wmk[n:].any()


ENGLISH = naive.gen_english(7, 60_000)
MULTI_BLOCK = naive.gen_english(8, 150_000)  # three 64 KiB blocks


@pytest.mark.parametrize(
    "text,pat,cs,ww",
    [
        (ENGLISH, b"the", True, False),
        (ENGLISH, b"THE", False, False),
        (ENGLISH, b"the", True, True),
        (ENGLISH, b"tHe", False, True),
        (MULTI_BLOCK, b"the", True, False),
        (MULTI_BLOCK, b"Holmes watson", False, True),
    ],
    ids=["cs", "i", "w", "i-w", "blocks", "blocks-i-w"],
)
def test_scan_literal_vs_pallas_and_xla(text, pat, cs, ww):
    jst, tst = stage_both(text)
    got = port_scan(tst, pat, cs, ww)
    assert_same(got, pallas_scan(jst, pat, cs, ww))
    assert_same(got, xla_scan(jst, pat, cs, ww))
    want = naive.all_starts(text, pat, cs, ww)
    assert np.flatnonzero(got[2]).tolist() == want
    assert got[1] == naive.matched_lines(text, want)


def test_matches_at_every_phase_and_across_blocks():
    body = bytearray(b"." * 200_000)
    for pos in [0, 1, 2, 3, 125, 126, 127, 128, 129, 510, 511, 512, 513,
                65530, 65531, 65532, 65533, 65534, 65535, 131069, 131070]:
        body[pos : pos + 9] = b"match\nyes"
    text = bytes(body)
    jst, tst = stage_both(text)
    for pat in (b"match\nyes", b"h\ny"):
        got = port_scan(tst, pat)
        assert np.flatnonzero(got[2]).tolist() == naive.all_starts(text, pat)
    assert_same(port_scan(tst, b"match\nyes"), pallas_scan(jst, b"match\nyes"))


@pytest.mark.parametrize("m", [1, 5, 17, 33, 63, 64])
def test_pattern_lengths_vs_pallas(m):
    text = MULTI_BLOCK
    start = text.find(b"\n", 1000 + 97 * m) + 1
    pat = text[start : start + m]
    cs = m % 2 == 1
    jst, tst = stage_both(text)
    got = port_scan(tst, pat, cs=cs)
    assert got[0] >= 1
    assert_same(got, pallas_scan(jst, pat, cs=cs))


def test_every_pattern_length_vs_host_scan():
    """m = 1..64, with and without -i/-w, against the JAX package's numpy
    shard scan (literal.scan_shard_host) and naive."""
    text = naive.gen_corpus(3, 70_000, alphabet=b"abcAB_ \n\nthe quick")
    _, tst = stage_both(text)
    for m in range(1, 65):
        pat = text[5 * m : 6 * m]
        cs, ww = m % 3 != 0, m % 4 == 1
        got = port_scan(tst, pat, cs, ww)
        c, f, trail, lead, has_nl, mk = jliteral.scan_shard_host(
            np.frombuffer(text, np.uint8), len(text), 0, len(text),
            pattern=pat, case_sensitive=cs, whole_word=ww, want_mask=True,
        )
        want = naive.all_starts(text, pat, cs, ww)
        assert (got[0], got[1]) == (c, f) == (len(want), naive.matched_lines(text, want)), m
        assert np.flatnonzero(got[2]).tolist() == np.flatnonzero(mk).tolist() == want, m


@pytest.mark.parametrize("pat", [b"\nthe", b"e\n"])
def test_newline_patterns(pat):
    """A match on a '\\n' byte belongs to the line that '\\n' ends."""
    text = naive.gen_english(11, 20_000)
    jst, tst = stage_both(text)
    got = port_scan(tst, pat)
    assert got[0] > 0
    assert_same(got, pallas_scan(jst, pat))
    assert_same(got, xla_scan(jst, pat))
    assert got[1] == naive.matched_lines(text, naive.all_starts(text, pat))


@pytest.mark.parametrize(
    "text,pat",
    [
        (b"_^ab cd\n", b"ab"),
        (b"_^ab_^ab ^ab\n", b"ab"),
        (b"_^^ab ab_^\n^^ab\n", b"ab"),
        (b"x_^cd_^^cd cd\n" * 3000, b"cd"),
    ],
)
def test_whole_word_after_underscore_caret(text, pat):
    """-w after `_^` is held to literal.py and naive, not to the Pallas
    kernel, whose swar_has_byte borrow drops these matches."""
    jst, tst = stage_both(text)
    got = port_scan(tst, pat, ww=True)
    assert_same(got, xla_scan(jst, pat, ww=True))
    want = naive.all_starts(text, pat, whole_word=True)
    assert np.flatnonzero(got[2]).tolist() == want
    assert got[1] == naive.matched_lines(text, want)


def shard_port(text, tl, prev, limit, pat, cs=True, ww=False):
    tst = dispatch.stage(text, CPU, true_len=tl)
    plain = literal.scan_shard(
        tst.u8, tl, prev, limit, pattern=pat, case_sensitive=cs,
        whole_word=ww, want_mask=True,
    )
    tot, mask, _ = dispatch.scan_literal_staged(
        tst, pattern=pat, case_sensitive=cs, whole_word=ww,
        prev_word=prev, start_limit=limit, want_mask=True,
    )
    stats = [int(x) for x in plain[:5]]
    assert tot[:5].tolist() == stats
    assert torch.equal(mask, plain[5][: mask.shape[0]])
    return stats, np.flatnonzero(mask.numpy()).tolist()


@pytest.mark.parametrize(
    "pat,cs,ww,prev",
    [(b"the", True, False, 0), (b"THE", False, True, 1), (b"\nthe", True, False, 0)],
)
def test_scan_shard_vs_pallas_and_host(pat, cs, ww, prev):
    text = naive.gen_english(13, 90_000)
    limit = 70_000  # element-aligned, as pallas_swar.scan_shard requires
    m = len(pat)
    slab = text[: limit + m]
    tl = limit + m - 1
    stats, starts = shard_port(slab, tl, prev, limit, pat, cs, ww)
    jst = jdispatch.stage(slab)
    c, f, trail, lead, has_nl, mk = pallas_swar.scan_shard(
        jst.u32, jnp.int32(tl), jnp.int32(prev), jnp.int32(limit),
        pattern=pat, case_sensitive=cs, whole_word=ww, want_mask=True,
        interpret=True,
    )
    assert stats == [int(c), int(f), int(trail), int(lead), int(has_nl)]
    assert starts == np.flatnonzero(np.asarray(mk).view(np.uint8)).tolist()
    host = jliteral.scan_shard_host(
        np.frombuffer(slab, np.uint8), tl, prev, limit, pattern=pat,
        case_sensitive=cs, whole_word=ww, want_mask=True,
    )
    assert stats == [int(x) for x in host[:5]]
    assert starts == np.flatnonzero(host[5]).tolist()


def test_scan_shard_corners_vs_host():
    """Unaligned limits, a match on the first newline (lead), prev_word."""
    cases = [
        (b"\nab\nxx ab", b"\nab", 0, 9),
        (b"ab\nab", b"ab", 0, 5),
        (b"xx\nab", b"ab", 0, 5),
        (b"zz\nxx ab\nyy", b"ab", 0, 11),
        (b"ab cd", b"ab", 1, 5),
        (b"ab cd ab", b"ab", 0, 3),
        (b"the\nthe the\n" * 20_000, b"the", 0, 150_001),
        (b"the\nthe the\n" * 20_000, b"e\nt", 1, 131_073),
    ]
    for text, pat, prev, limit in cases:
        for cs, ww in [(True, False), (False, True)]:
            tl = min(limit + len(pat) - 1, len(text))
            stats, starts = shard_port(text, tl, prev, limit, pat, cs, ww)
            host = jliteral.scan_shard_host(
                np.frombuffer(text, np.uint8), tl, prev, limit, pattern=pat,
                case_sensitive=cs, whole_word=ww, want_mask=True,
            )
            assert stats == [int(x) for x in host[:5]], (text[:20], pat, cs, ww)
            assert starts == np.flatnonzero(host[5]).tolist()


def test_phase_words_match_pallas():
    for pat in [b"a", b"ab", b"the", b"abcd", b"quick", b"\x00\xff\n", bytes(range(33, 97))]:
        for p in range(4):
            assert convert.phase_words(pat, p) == pallas_swar._phase_words(pat, p)


def _slab_stats(text: bytes, pat: bytes, cuts):
    """Per-slab (count, lead, trail, any, has_nl) from the JAX package's
    host shard scan, over slabs [cuts[i], cuts[i+1])."""
    data = np.frombuffer(text, np.uint8)
    out = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        slab = data[lo : min(hi + len(pat), len(data))]
        tl = min(hi - lo + len(pat) - 1, len(slab))
        c, f, trail, lead, has_nl, _ = jliteral.scan_shard_host(
            slab, tl, 0, hi - lo, pattern=pat
        )
        out.append((f, lead, trail, c > 0, has_nl))
    return out


def test_line_combiners_match_mesh():
    rng = np.random.default_rng(5)
    for trial in range(30):
        text = naive.gen_corpus(trial, int(rng.integers(50, 5000)), alphabet=b"ab \n")
        cuts = sorted({0, len(text), *rng.integers(1, len(text), size=int(rng.integers(1, 12))).tolist()})
        for pat in (b"a", b"ab", b"b\na"):
            st = _slab_stats(text, pat, cuts)
            cols = list(zip(*st))
            want = naive.matched_lines(text, naive.all_starts(text, pat))
            assert mesh.combine_line_counts(*cols) == want
            comb = lines.LineCountCombiner()
            for row in st:
                comb.push(*row)
            assert comb.total == want
            blocks = torch.tensor(
                [[int(a), f, int(tr), int(ld), int(nl), 0, 0, 0] for f, ld, tr, a, nl in st],
                dtype=torch.int32,
            )
            assert lines.combine_block_stats(blocks)[1].item() == want


@pytest.mark.parametrize("n", [1, 1025, 24_577])
def test_combine_block_stats_vs_sequential_fold(n):
    """The vectorised fold against LineCountCombiner pushed row by row,
    at block counts on both sides of the combine kernel's 1024 threads."""
    rows = random_summaries(np.random.default_rng(n), n)
    comb = lines.LineCountCombiner()
    trail = lead = has_nl = False
    for c, f, tr, ld, nl, *_ in rows.tolist():
        comb.push(f, ld, tr, c > 0, nl)
        lead = lead or (ld and not has_nl)
        trail = tr if nl else (trail or tr)
        has_nl = has_nl or nl
    want = [int(rows[:, 0].sum()), comb.total, int(trail), int(lead), int(has_nl), 0, 0, 0]
    got = swar.combine_blocks(torch.from_numpy(rows))  # the CPU route: the plain fold
    assert got.tolist() == want


def test_chunked_newline_scan(monkeypatch):
    """The line ids do not depend on the chunk the newline scan runs in."""
    text = naive.gen_corpus(21, 200_000, alphabet=b"ab the\n\n")
    tst = dispatch.stage(text, CPU)
    nl = tst.u8 == 10
    whole = torch.cumsum(nl, 0, dtype=torch.int32)
    kw = dict(pattern=b"the", prev_word=1, start_limit=190_001, want_mask=True)
    want = literal.block_stats(tst.u8, tst.true_len, tst.n_blocks, **kw)
    for chunk in (1000, 65536, 65537):
        monkeypatch.setattr(literal, "SCAN_CHUNK", chunk)
        assert torch.equal(literal._newlines_through(nl), whole)
        got = literal.block_stats(tst.u8, tst.true_len, tst.n_blocks, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_block_route_matches_plain_on_random_texts():
    rng = np.random.default_rng(9)
    for trial in range(12):
        text = naive.gen_corpus(100 + trial, int(rng.integers(1, 200_000)),
                                alphabet=b"abcAB_^ \n\nthe\xc1\xe1[@`{")
        tst = dispatch.stage(text, CPU)
        for pat in (b"a", b"the", b"\nthe", b"e\n", b"b a", b"_^", b"\xc1a", b"[A"):
            for cs, ww in [(True, False), (False, True), (True, True)]:
                got = port_scan(tst, pat, cs, ww)
                want = naive.all_starts(text, pat, cs, ww)
                assert np.flatnonzero(got[2]).tolist() == want
                assert got[1] == naive.matched_lines(text, want)


def test_staging_contract_matches_reference():
    for n in [0, 1, 127, 128, 65536, 65537, 3 * 65536 + 5, 1 << 20, (1 << 20) + 1]:
        assert dispatch.bucket_size(n) == jdispatch.bucket_size(n)
    text = naive.gen_english(2, 100_000)
    st = dispatch.stage(text, CPU)
    assert np.array_equal(st._np, jdispatch.stage(text)._np)
    assert st.n_blocks * 65536 + dispatch.HALO_BYTES == st.u8.shape[0]
    with pytest.raises(ValueError):
        convert.staged_from_reference(np.ones(10, np.uint8), 3, CPU)


PIPE_CHUNK = 3 * 65536  # the pipeline's chunk in the tests: three blocks
PIPE_LENGTHS = [0, 1, PIPE_CHUNK - 1, PIPE_CHUNK, PIPE_CHUNK + 1, 2 * PIPE_CHUNK + 5,
                7 * PIPE_CHUNK + 4095]


@pytest.mark.parametrize("true_len", [None, "short"], ids=["whole", "true_len"])
@pytest.mark.parametrize("source", ["bytes", "array", "memmap"])
@pytest.mark.parametrize("n", PIPE_LENGTHS)
def test_staging_pipeline_matches_reference(n, source, true_len, tmp_path, monkeypatch):
    """Texts around the chunk's edges staged through the chunked fill (two
    chunks or more) and the single copy: the staged layout is krep_tpu's
    byte for byte, and the counters say which path ran."""
    monkeypatch.setattr(dispatch, "CHUNK_BYTES", PIPE_CHUNK)
    text = naive.gen_corpus(n, n, alphabet=b"abcthe \n\x00\xff")
    if source == "bytes":
        src = text
    else:
        src = np.frombuffer(text, np.uint8).copy()
        if source == "memmap" and n:  # numpy maps no empty file
            path = tmp_path / "t.bin"
            path.write_bytes(text)
            src = np.memmap(path, dtype=np.uint8, mode="r")
    tl = None if true_len is None else max(0, n - 3)
    before = (profiling.counter("stage.pipelined"), profiling.counter("stage.chunks"))
    st = dispatch.stage(src, CPU, true_len=tl)
    assert np.array_equal(st._np, jdispatch.stage(text)._np)
    assert st.u8.data_ptr() == st._host.data_ptr()  # the host buffer itself on the CPU
    assert (st.n, st.true_len) == (n, n if tl is None else tl)
    assert st.tail_zero == (tl is None or tl >= n)
    piped = n >= 2 * PIPE_CHUNK
    chunks = dispatch.bucket_size(n) // PIPE_CHUNK if piped else 0
    after = (profiling.counter("stage.pipelined"), profiling.counter("stage.chunks"))
    assert after == (before[0] + piped, before[1] + chunks)


def test_fill_pool_is_made_once_a_process(monkeypatch):
    """One pool of fill threads a process, never more than FILL_WORKERS, and
    a new one where the pid changed (a forked child's)."""
    monkeypatch.setattr(dispatch, "_POOL", None)  # the process's own pool comes back after
    pool = dispatch._fill_pool()
    assert dispatch._fill_pool() is pool
    assert pool._max_workers == min(dispatch.FILL_WORKERS, len(os.sched_getaffinity(0)))
    pid = os.getpid()
    monkeypatch.setattr(os, "getpid", lambda: pid + 1)
    child = dispatch._fill_pool()
    assert child is not pool and dispatch._fill_pool() is child
    for p in (pool, child):
        p.shutdown()


@pytest.mark.parametrize("density", ["empty", "sparse", "dense"])
def test_starts_from_device_mask(density):
    rng = np.random.default_rng(1)
    size = 8 * 65536
    mask = np.zeros(size, np.uint8)
    if density == "sparse":
        mask[rng.integers(0, size, 40)] = 1
    elif density == "dense":
        mask[rng.random(size) < 0.1] = 1
    n = size - 1000
    t = torch.from_numpy(mask)
    want = np.flatnonzero(mask[:n]).tolist()
    assert dispatch.starts_from_device_mask(t, n).tolist() == want
    counts = t.view(-1, 65536).sum(1, dtype=torch.int32)
    assert dispatch.starts_from_device_mask(t, n, counts).tolist() == want
    packed = dispatch._pack_mask_bits(t).numpy()
    assert np.array_equal(packed, np.packbits(mask, bitorder="little"))


def test_device_resolution(monkeypatch):
    monkeypatch.setenv("KREP_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        dispatch.resolve_device()
    with pytest.raises(RuntimeError):
        dispatch.stage(b"abc")
    assert dispatch.resolve_device("cpu") == CPU
    monkeypatch.setenv("KREP_TORCH_DEVICE", "cpu")
    assert dispatch.resolve_device() == CPU
    with pytest.raises(ValueError):
        dispatch.resolve_device("meta")


def test_wrapper_rejects_bad_input():
    tst = dispatch.stage(b"abc", CPU)
    with pytest.raises(ValueError):
        swar.scan_blocks(tst.u8, 3, tst.n_blocks, pattern=b"x" * 65)
    with pytest.raises(ValueError):
        swar.scan_blocks(tst.u8, 3, tst.n_blocks, pattern=b"")
    with pytest.raises(ValueError):
        swar.scan_blocks(tst.u8[:1000], 3, 1, pattern=b"a")
    with pytest.raises(ValueError):
        swar.combine_blocks(torch.zeros((2, 5), dtype=torch.int32))
