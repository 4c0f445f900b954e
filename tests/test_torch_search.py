"""krep_tpu_torch search and CLI against krep_tpu, on the CPU.

The port runs with device="cpu" (its kernels' plain PyTorch versions); the
JAX package runs as its own tests run it here. Counts, positions, CLI
stdout and exit codes must be identical. tests/conftest.py sets
KREP_TPU_HOST_BREAKEVEN=0, so both packages take their device paths.
"""

import io
import os
import subprocess
import sys
import tempfile

import pytest
import torch

import krep_tpu
import naive
from krep_tpu import cli as jcli
from krep_tpu.engine.select import select_algorithm
from krep_tpu_torch import SearchParams, cli, search_file, search_string
from krep_tpu_torch.engine import search as search_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXT = naive.gen_english(21, 50_000)
LONG_PAT = b"the quick brown fox jumps over lazy dog Sherlock Holmes watson " * 2


def _text_with_long_pattern() -> bytes:
    parts = TEXT.split(b"\n")
    for i in (3, 100, 101, 500):
        parts[i] = parts[i] + b" " + LONG_PAT[:70] + b" x"
    return b"\n".join(parts)


MODES = [
    ("c", dict(count_mode=True)),
    ("c-o", dict(count_mode=True, only_matching=True)),
    ("o", dict(only_matching=True)),
    ("lines", dict()),
    ("m", dict(max_count=3, only_matching=True)),
    ("m-c", dict(max_count=7, count_mode=True)),
    ("i", dict(case_sensitive=False, only_matching=True)),
    ("w", dict(whole_word=True)),
    ("i-w-c", dict(case_sensitive=False, whole_word=True, count_mode=True)),
]


def same(a, b):
    assert a.count == b.count
    assert a.text_len == b.text_len
    assert a.positions.tolist() == b.positions.tolist()


@pytest.mark.parametrize("name,kw", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("pat", [b"the", b"Sherlock", b"e"])
def test_search_string_matches_krep_tpu(name, kw, pat):
    p = SearchParams(patterns=(pat,), **kw)
    same(search_string(p, TEXT, device="cpu"), krep_tpu.search_string(p, TEXT))


def test_memchr_short_only_matching():
    """-i -o with m < 4 takes the memchr_short emulation on the host."""
    for pat in (b"th", b"aa", b"THE"):
        p = SearchParams(patterns=(pat,), case_sensitive=False, only_matching=True)
        same(search_string(p, TEXT, device="cpu"), krep_tpu.search_string(p, TEXT))


def test_patterns_over_64_bytes():
    text = _text_with_long_pattern()
    for kw in (dict(only_matching=True), dict(count_mode=True),
               dict(whole_word=True), dict(case_sensitive=False, count_mode=True, only_matching=True)):
        for pat in (LONG_PAT[:70], LONG_PAT[:65].upper()):
            p = SearchParams(patterns=(pat,), **kw)
            got = search_string(p, text, device="cpu")
            same(got, krep_tpu.search_string(p, text))
    p = SearchParams(patterns=(LONG_PAT[:70],), count_mode=True)
    assert search_string(p, text, device="cpu").count == 4


def test_multi_block_text_and_group_readback():
    """A 200 KB text spans four 64 KiB groups, so the mask readback takes
    the per-group path."""
    text = naive.gen_english(22, 200_000)
    for kw in (dict(only_matching=True), dict(count_mode=True), dict(whole_word=True, only_matching=True)):
        for pat in (b"the", b"Holmes"):
            p = SearchParams(patterns=(pat,), **kw)
            same(search_string(p, text, device="cpu"),
                 krep_tpu.search_string(p, text, threads=1))


@pytest.mark.parametrize("name,kw", MODES, ids=[m[0] for m in MODES])
def test_slab_loop_matches_krep_tpu(name, kw, monkeypatch):
    """Texts over SLAB_BYTES stream in slabs with halos and exact line
    merging; a small slab size makes 300 KB take four slabs."""
    text = naive.gen_english(23, 300_000)
    monkeypatch.setattr(search_mod, "SLAB_BYTES", 80_000)
    for pat in (b"the", b"e\nthe"):
        p = SearchParams(patterns=(pat,), **kw)
        same(search_string(p, text, device="cpu"),
             krep_tpu.search_string(p, text, threads=1))


@pytest.mark.parametrize("base", [b"x", b" ", b"\n"])
def test_slab_boundary_matches(base, monkeypatch):
    """Matches that end at, cross, and start at a slab edge are found once;
    -w sees the real bytes on both sides of the edge."""
    text = bytearray(base * 350_000)
    for pos in (99_994, 199_999, 300_000):
        text[pos : pos + 6] = b"needle"
    text = bytes(text)
    monkeypatch.setattr(search_mod, "SLAB_BYTES", 100_000)
    for kw in (dict(only_matching=True), dict(whole_word=True, only_matching=True),
               dict(count_mode=True), dict(whole_word=True, count_mode=True)):
        p = SearchParams(patterns=(b"needle",), **kw)
        got = search_string(p, text, device="cpu")
        same(got, krep_tpu.search_string(p, text, threads=1))
        want = naive.all_starts(text, b"needle", whole_word=p.whole_word)
        if p.count_mode:
            assert got.count == naive.matched_lines(text, want)
        else:
            assert got.positions[:, 0].tolist() == want


def test_slab_early_exit_with_max_count():
    text = naive.gen_english(24, 300_000)
    for kw in (dict(max_count=5, only_matching=True), dict(max_count=2, count_mode=True),
               dict(max_count=4)):
        p = SearchParams(patterns=(b"the",), **kw)
        sel = select_algorithm(p)
        got = search_mod._search_single_literal_slabbed(
            p, text, sel.policy(p.only_matching), search_mod.dispatch.resolve_device("cpu"),
            slab_bytes=65536,
        )
        same(got, krep_tpu.search_string(p, text, threads=1))


def test_search_file_and_not_ported(tmp_path):
    path = tmp_path / "t.txt"
    path.write_bytes(TEXT)
    p = SearchParams(patterns=(b"the",), count_mode=True)
    assert search_file(p, str(path), device="cpu").count == krep_tpu.search_file(p, str(path)).count
    p = SearchParams(patterns=(b"a", b"b"))  # several patterns search now (tests/test_torch_multi.py)
    same(search_string(p, TEXT, device="cpu"), krep_tpu.search_string(p, TEXT, threads=1))
    with pytest.raises(NotImplementedError, match="not ported"):
        search_string(SearchParams(patterns=(b"a.c",), use_regex=True), TEXT, device="cpu")


# the single-pattern argument sets of tests/test_cli_parity.py
ARGSETS = [
    ["the"],
    ["-c", "the"],
    ["-o", "the"],
    ["-c", "-o", "the"],
    ["-i", "THE"],
    ["-i", "-o", "THE"],
    ["-w", "the"],
    ["-w", "-o", "fox"],
    ["-m", "3", "-o", "the"],
    ["-m", "2", "the"],
    ["-m", "0", "-c", "the"],
    ["--algo", "bm", "-o", "aaa"],
    ["--algo", "kmp", "-c", "-o", "aaa"],
    ["zzqqxx"],
    ["-c", "zzqqxx"],
    ["e"],
    ["-o", "th"],
    ["--color=always", "the"],
    ["--color=always", "-o", "the"],
    ["--no-simd", "-c", "-o", "aba"],
]


def run(main, argv, **kw):
    out = io.BytesIO()
    rc = main(list(argv), out=out, **kw)
    return out.getvalue(), rc


@pytest.fixture(scope="module")
def corpus_file():
    text = naive.gen_english(5, 30_000)
    with tempfile.NamedTemporaryFile(suffix=".txt", delete=False) as f:
        f.write(text)
        path = f.name
    yield path
    os.unlink(path)


@pytest.mark.parametrize("args", ARGSETS, ids=lambda a: " ".join(a))
def test_cli_matches_krep_tpu(corpus_file, args):
    got = run(cli.main, [*args, corpus_file], device="cpu")
    assert got == run(jcli.main, [*args, corpus_file])


def test_cli_string_mode_and_errors(tmp_path):
    for argv in (["-s", "the", "the theme thread"], ["-o", "-s", "he", "hehe he"],
                 ["-c"], ["-m", "x", "-c", "the", str(tmp_path / "missing")],
                 ["-e", "a", "-e", "b", "-s", "ab"]):
        assert run(cli.main, argv, device="cpu") == run(jcli.main, argv)
    for argv in (["-E", "a.c", str(tmp_path)], ["-r", "the", str(tmp_path)],
                 ["-r", "-e", "a", "-e", "b", str(tmp_path)]):
        assert run(cli.main, argv, device="cpu")[1] == 2
    out, rc = run(cli.main, ["-v"], device="cpu")
    assert rc == 0 and b"torch" in out


def test_cli_without_the_device_exits_2(monkeypatch):
    monkeypatch.setenv("KREP_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run(cli.main, ["-c", "-s", "a", "a"]) == (b"", 2)
    assert run(cli.main, ["-v"]) == (b"", 2)


NO_JAX = r"""
import io, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked")

sys.meta_path.insert(0, Block())
import krep_tpu_torch
from krep_tpu_torch import SearchParams, cli, search_string

text = b"the cat\nthe theme\nno\n" * 5000
r = search_string(SearchParams(patterns=(b"the",), count_mode=True), text, device="cpu")
assert r.count == 10000, r.count
r = search_string(SearchParams(patterns=(b"the",), only_matching=True), text, device="cpu")
assert r.count == 15000, r.count
out = io.BytesIO()
assert cli.main(["-c", "-s", "the", "the a the\nb the"], out=out) == 0
assert out.getvalue() == b"2\n", out.getvalue()
# multi-pattern: fused pass (K=3), Hamming products (K=40) and its -c lines
pats = [b"the", b"cat", b"theme"] + [b"x%02d" % i for i in range(37)]
r = search_string(SearchParams(patterns=tuple(pats[:3]), only_matching=True), text, device="cpu")
assert r.count == 25000, r.count
r = search_string(SearchParams(patterns=tuple(pats), count_mode=True, only_matching=True), text, device="cpu")
assert r.count == 25000, r.count
r = search_string(SearchParams(patterns=tuple(pats), count_mode=True), text, device="cpu")
assert r.count == 10000, r.count
out = io.BytesIO()
assert cli.main(["-c", "-e", "cat", "-s", "no", "a cat\nno"], out=out) == 0
assert out.getvalue() == b"2\n", out.getvalue()
assert "jax" not in sys.modules
print("no-jax ok")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, KREP_TORCH_DEVICE="cpu", KREP_TPU_HOST_BREAKEVEN="0",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", NO_JAX], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax ok" in proc.stdout
