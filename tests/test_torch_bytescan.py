"""krep_tpu_torch's byte scan (KREP_TPU_BACKEND=pallas) and its
cost-attribution variants against the JAX package, on the CPU.

The plain version of the byte kernel (bytescan.block_stats_bytes) is held
to krep_tpu/ops/pallas_scan.scan_literal in interpret mode on
tests/test_pallas_scan.py's cases (patterns up to 17 bytes: interpret mode
traces one shifted compare per pattern byte), and to tests/naive.py for
patterns of 65..4096 bytes; the variants' plain versions to
tools/bench_kernel.py's variant_kernel in an interpret-mode pallas_call with
run_variant's grid; the port's CLI under KREP_TPU_BACKEND=pallas to
krep_tpu.cli. Inputs come from fixed seeds; every comparison is exact.
"""

import functools
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import naive
from krep_tpu import cli as jcli
from krep_tpu.ops import dispatch as jdispatch
from krep_tpu.ops import pallas_scan
from krep_tpu_torch import SearchParams, cli, convert, search_string
from krep_tpu_torch.engine import search as search_mod
from krep_tpu_torch.ops import bytescan, dispatch, swar
from krep_tpu_torch.parallel import lines

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
BLOCK = bytescan.BLOCK_BYTES


def stage_both(text: bytes):
    jst = jdispatch.stage(text)
    return jst, convert.staged_from_reference(jst._np, len(text), CPU)


def plain_scan(tst, pat, cs=True, ww=False):
    """[count, lines] and the start offsets of the byte scan's plain version."""
    stats, mask, tot = bytescan.scan_blocks_bytes(
        tst.u8, tst.true_len, tst.n_blocks, pattern=pat, case_sensitive=cs,
        whole_word=ww, want_mask=True,
    )
    assert torch.equal(tot, lines.combine_block_stats(stats))
    return tot[:2].tolist(), torch.nonzero(mask).squeeze(1).tolist()


# ------------------------------------------------ against pallas_scan

T = pallas_scan.TILE_ROWS * pallas_scan.LANES  # 65536


def _tile_boundary_text():
    body = bytearray(b"x" * (3 * T))
    for pos in [T - 3, T - 1, T, 2 * T - 2, 2 * T]:
        body[pos : pos + 5] = b"match"
    body[100] = 0x0A
    body[T + 7] = 0x0A
    return bytes(body)


def _word_boundary_text():
    body = bytearray(b" " * (2 * T))
    body[T - 4 : T + 1] = b"word_"
    body[T + 10 : T + 14] = b"word"
    return bytes(body)


# tests/test_pallas_scan.py's cases: (text, pattern, case_sensitive, whole_word)
PALLAS_CASES = {
    "abababa": (b"abababa", b"aba", True, False),
    "aaaaa": (b"aaaaa", b"aa", True, False),
    "the-lines": (b"the theme thread\nthe end", b"the", True, False),
    "whole": (b"hello", b"hello", True, False),
    "needle": (b"x" * 100000 + b"needle" + b"y" * 100000, b"needle", True, False),
    "corpus-the": (naive.gen_corpus(11, 70_000), b"the", True, False),
    "corpus-TH-i": (naive.gen_corpus(11, 70_000), b"TH", False, False),
    "corpus-e-w": (naive.gen_corpus(11, 70_000), b"e", True, True),
    "corpus-e q-i-w": (naive.gen_corpus(11, 70_000), b"e q", False, True),
    "tile-boundary": (_tile_boundary_text(), b"match", True, False),
    "word-across-tiles": (_word_boundary_text(), b"word", True, True),
    "line-carry": (b"ab " * (T // 3) + b"ab ab\n" + b"ab " * 100, b"ab", True, False),
    "m17-i-w": (naive.gen_english(12, 140_000), b"Sherlock Holmes w", False, True),
}


@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_block_stats_bytes_matches_pallas_scan(name):
    text, pat, cs, ww = PALLAS_CASES[name]
    jst, tst = stage_both(text)
    c, l, mk = pallas_scan.scan_literal(
        jst.u8, jst.true_len, pattern=pat, case_sensitive=cs, whole_word=ww,
        want_mask=True, interpret=True,
    )
    (count, nlines), starts = plain_scan(tst, pat, cs, ww)
    assert [count, nlines] == [int(c), int(l)]
    assert starts == np.flatnonzero(np.asarray(mk)[: len(text)]).tolist()
    want = naive.all_starts(text, pat, cs, ww)
    assert starts == want and nlines == naive.matched_lines(text, want)


def long_pattern_text(m: int, seed: int) -> tuple[bytes, bytes]:
    """About 3.3 blocks of text with a pattern of m bytes cut from it and
    planted across the first two block edges, at a line start, at the
    text's end, and after "_" and "^" (-w)."""
    text = bytearray(naive.gen_english(seed, 3 * BLOCK + 20_000))
    pat = bytes(text[500 : 500 + m]).replace(b"\n", b" ")
    pat = b"Q" + pat[1:-1] + b"z"  # word bytes at both ends; 'Q' folds under -i
    for at in (BLOCK - m // 2, 2 * BLOCK - 1, 1000 + 3 * m):
        text[at - 1 : at + m + 1] = b" " + pat + b"\n"
    text[2 * BLOCK + 5000 : 2 * BLOCK + 5003 + m] = b"_^" + pat + b" "
    text[-m - 1 :] = b" " + pat
    return bytes(text), pat


@pytest.mark.parametrize("m", [65, 1000, 4096])
def test_long_patterns_match_naive(m, monkeypatch):
    """65..4096-byte patterns (the range the engine's prefix filter keeps
    from the kernel, reached through bytescan and dispatch directly)."""
    text, pat = long_pattern_text(m, m)
    tst = dispatch.stage(text, CPU)
    monkeypatch.setenv("KREP_TPU_BACKEND", "pallas")
    for cs, ww in [(True, False), (False, True), (True, True)]:
        p = pat if cs else pat.lower()
        want = naive.all_starts(text, p, cs, ww)
        assert len(want) >= 3
        got, starts = plain_scan(tst, p, cs, ww)
        assert starts == want
        assert got == [len(want), naive.matched_lines(text, want)]
        totals, mask, group_counts = dispatch.scan_literal_staged(
            tst, pattern=p, case_sensitive=cs, whole_word=ww, want_mask=True)
        assert totals[:2].tolist() == got and torch.nonzero(mask).squeeze(1).tolist() == want
        assert int(group_counts.sum()) == len(want)


def test_pattern_length_bounds():
    tst = dispatch.stage(b"abc" * 1000, CPU)
    for pat in (b"", b"a" * 4097):
        with pytest.raises(ValueError):
            bytescan.scan_blocks_bytes(tst.u8, tst.true_len, tst.n_blocks, pattern=pat)
    bytescan.scan_blocks_bytes(tst.u8, tst.true_len, tst.n_blocks, pattern=b"a" * 4096)


# ------------------------------------------------ the cost-attribution variants

@functools.cache
def _bench_kernel_tool():
    spec = importlib.util.spec_from_file_location("bench_kernel_tool",
                                                  REPO / "tools" / "bench_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_variant(text: bytes, mode: str, pat: bytes) -> list[int]:
    """tools/bench_kernel.py's variant_kernel in an interpret-mode
    pallas_call with run_variant's grid spec (:97-115)."""
    bk = _bench_kernel_tool()
    arr, n = jdispatch.stage_text(text)
    rows_total = arr.shape[0] // pallas_scan.LANES
    R = rows_total - pallas_scan.HALO_ROWS
    text2d = arr.reshape(rows_total, pallas_scan.LANES)
    tl = jnp.reshape(n.astype(jnp.int32), (1,))
    TR, L, H = pallas_scan.TILE_ROWS, pallas_scan.LANES, pallas_scan.HALO_ROWS
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(R // TR,),
        in_specs=[
            pl.BlockSpec((TR, L), lambda i, t: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((H, L), lambda i, t: ((i + 1) * (TR // H), 0), memory_space=pltpu.VMEM),
        ],
        out_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        scratch_shapes=[pltpu.SMEM((8,), jnp.int32)],
    )
    out = pl.pallas_call(
        bk.variant_kernel(mode, len(pat), pat), grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((2,), jnp.int32)], interpret=True,
    )(tl, text2d, text2d)
    return np.asarray(out[0]).tolist()


VARIANT_TEXT = naive.gen_corpus(5, 150_000, b"the fox\nab") + b"the"


@pytest.mark.parametrize("mode", bytescan.VARIANTS)
def test_variant_plain_matches_bench_kernel(mode):
    jst, tst = stage_both(VARIANT_TEXT)
    want = jax_variant(VARIANT_TEXT, mode, b"the")
    got = bytescan.run_variant(tst.u8, tst.true_len, tst.n_blocks, mode=mode, pattern=b"the")
    assert got.tolist() == want
    stats = bytescan.scan_variant(tst.u8, tst.true_len, tst.n_blocks, mode=mode)
    assert torch.equal(stats, bytescan.variant_stats_plain(tst.u8, tst.true_len, tst.n_blocks,
                                                           mode=mode))
    n = len(naive.all_starts(VARIANT_TEXT, b"the"))
    if mode == "passthrough":
        assert want == [sum(VARIANT_TEXT), 0]
    else:
        assert want[0] == n
    with pytest.raises(ValueError):
        bytescan.scan_variant(tst.u8, tst.true_len, tst.n_blocks, mode="count_only")


def test_passthrough_sum_wraps_as_int32():
    """The byte sum of passthrough wraps as jnp.sum's int32 accumulation
    does (a block sum stays below 2^24, the total does not)."""
    stats = torch.zeros((150, 8), dtype=torch.int32)
    stats[:, 0] = 255 * BLOCK
    total = 150 * 255 * BLOCK
    assert int(lines.combine_block_stats(stats)[0]) == (total + 2**31) % 2**32 - 2**31 < 0


def test_bench_kernel_tool_needs_a_card(capsys):
    from krep_tpu_torch.tools import bench_kernel

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert bench_kernel.main(["1"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


# ------------------------------------------------ the backend knob and staging views

def test_backend_knob(monkeypatch):
    for mode in ("auto", "swar", "xla", "pallas"):
        monkeypatch.setenv("KREP_TPU_BACKEND", mode)
        assert dispatch.backend() == mode
    monkeypatch.delenv("KREP_TPU_BACKEND")
    assert dispatch.backend() == "auto"
    # any other value takes the default (SWAR) route, as krep_tpu's does
    calls = []
    real = swar.scan_blocks
    monkeypatch.setattr(swar, "scan_blocks", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(bytescan, "scan_blocks_bytes", None)  # never reached
    monkeypatch.setenv("KREP_TPU_BACKEND", "mosaic")
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    assert dispatch.backend() == "mosaic"
    text = naive.gen_english(8, 20_000)
    got = search_string(SearchParams(patterns=(b"the",), count_mode=True), text, device="cpu")
    assert calls and got.count == naive.matched_lines(text, naive.all_starts(text, b"the"))


@pytest.mark.parametrize("mode", ["mosaic", ""])
def test_cli_under_unknown_backend_matches_krep_tpu(mode, tmp_path, monkeypatch):
    """KREP_TPU_BACKEND=<a value neither package names>: the port's CLI
    gives krep_tpu's stdout and exit code."""
    small = tmp_path / "small.txt"
    small.write_bytes(b"the cat\nno match\nthen the end\n")
    monkeypatch.setenv("KREP_TPU_BACKEND", mode)
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    outs = []
    for main, kw in ((cli.main, dict(device="cpu")), (jcli.main, {})):
        out = io.BytesIO()
        outs.append((main(["-c", "the", str(small)], out=out, **kw), out.getvalue()))
    assert outs[0] == outs[1] == (0, f"{small}:2\n".encode())


def test_with_len_view_and_tail_zero():
    text = naive.gen_english(3, 100_000)
    st = dispatch.stage(text, CPU)
    assert st.tail_zero and st.true_len == st.n == len(text)
    v = st.with_len(len(text) - 17)
    assert (v.n, v.true_len, v.tail_zero, v.n_blocks) == (len(text) - 17, len(text) - 17,
                                                          False, st.n_blocks)
    assert v.u8.data_ptr() == st.u8.data_ptr() and st.n == len(text)
    assert st.with_len(len(text), tail_zero=True).tail_zero
    with pytest.raises(ValueError):
        st.with_len(st.n_blocks * BLOCK + 1)
    assert not dispatch.stage(text, CPU, true_len=len(text) - 3).tail_zero
    jst = jdispatch.stage(text)
    jv = jst.with_len(len(text) - 4095)
    pv = convert.staged_from_reference(jv._np, len(text), CPU, true_len=jv.n)
    assert (pv.n, pv.true_len, pv.tail_zero) == (jv.n, jv.n, False)
    with pytest.raises(ValueError):  # without true_len the tail must be zero
        convert.staged_from_reference(jst._np, len(text) - 5, CPU)


def test_byte_scan_routes(monkeypatch):
    """Under pallas the single-array route and the prefix filter run the
    byte scan; the slab loop (start_limit) and -r -c (first_line) keep the
    SWAR scan; without pallas nothing runs the byte scan."""
    calls = []
    for mod, name in ((bytescan, "scan_blocks_bytes"), (swar, "scan_blocks")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: calls.append(
            (_n, k.get("mask_kind", "starts"))) or _f(*a, **k))
    text = naive.gen_english(9, 120_000)
    monkeypatch.setenv("KREP_TPU_BACKEND", "pallas")
    search_string(SearchParams(patterns=(b"the",), count_mode=True), text, device="cpu")
    search_string(SearchParams(patterns=(b"the",), only_matching=True), text, device="cpu")
    search_string(SearchParams(patterns=(b"the quick " * 8,), count_mode=True), text, device="cpu")
    assert [c[0] for c in calls] == ["scan_blocks_bytes"] * 3
    calls.clear()
    monkeypatch.setattr(search_mod, "SLAB_BYTES", 50_000)
    search_string(SearchParams(patterns=(b"the",), count_mode=True), text, device="cpu")
    assert {c[0] for c in calls} == {"scan_blocks"} and len(calls) == 3
    calls.clear()
    monkeypatch.setenv("KREP_TPU_BACKEND", "auto")
    monkeypatch.setattr(search_mod, "SLAB_BYTES", 1 << 30)
    search_string(SearchParams(patterns=(b"the",), only_matching=True), text, device="cpu")
    assert calls == [("scan_blocks", "starts")]


# ------------------------------------------------ the CLI under KREP_TPU_BACKEND=pallas

CLI_ARGSETS = [
    ["-c", "the"],
    ["-o", "the"],
    ["the"],
    ["-c", "-i", "-w", "the"],
    ["-o", "-w", "-i", "HOLMES"],
    ["-c", "-o", "LONG70"],
    ["-m", "3", "-o", "the"],
    ["-r", "-c", "-o", "the"],
    ["-r", "-o", "the"],
    ["-r", "-c", "the"],
]


@pytest.mark.parametrize("args", CLI_ARGSETS, ids=lambda a: " ".join(a))
def test_cli_under_pallas_matches_krep_tpu(args, tmp_path, monkeypatch):
    text = naive.gen_english(41, 150_000)
    long70 = text[10_000:10_070].replace(b"\n", b" ")
    text = text[:80_000] + long70 + b" " + text[80_000:] + long70
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(text)
    for i in range(5):
        (tmp_path / f"f{i}.txt").write_bytes(naive.gen_english(50 + i, 3000 * i + 10))
    target = str(tmp_path) if "-r" in args else str(corpus)
    argv = [long70.decode() if a == "LONG70" else a for a in args] + [target]
    calls = []
    real = bytescan.scan_blocks_bytes
    monkeypatch.setattr(bytescan, "scan_blocks_bytes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("KREP_TPU_BACKEND", "pallas")
    out = io.BytesIO()
    got = (cli.main(argv, out=out, device="cpu"), out.getvalue())
    monkeypatch.setenv("KREP_TPU_BACKEND", "xla")
    out = io.BytesIO()
    want = (jcli.main(argv, out=out), out.getvalue())
    assert got == want and got[0] == 0
    assert bool(calls) == (args != ["-r", "-c", "the"])  # -r -c: the SWAR first_line scan
