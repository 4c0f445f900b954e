"""The reference (benchmark/reference) against the program's CLI on the CPU.

Small generated inputs: the corpus recipe with stretches of long lines (so
lines and matches cross 64 KiB blocks) and members that overlap. The
program runs on its host
route and on its device route (the plain PyTorch versions, with the
break-even at 0); both must print what the reference says, byte for byte.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from recipes import linux_tree, mixed_set, subtitles_corpus  # noqa: E402
from reference import krep_ref, scan, tree  # noqa: E402

from krep_tpu_torch import cli  # noqa: E402


def long_lines(text: np.ndarray, seed: int) -> np.ndarray:
    """Newlines blanked in some stretches: lines of hundreds of bytes to
    over 64 KiB."""
    rng = np.random.default_rng(seed)
    out = text.copy()
    n = out.shape[0]
    for lo, hi, k in ((300, 1_500, 40), (5_000, 40_000, 6), (70_000, 140_000, 2)):
        for start, length in zip(rng.integers(0, n - hi, k), rng.integers(lo, hi, k)):
            seg = out[start : start + length]
            seg[seg == 10] = 32
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    text = long_lines(subtitles_corpus.corpus(300_000, 41), 5)
    # a last line without a newline and with matches past the last newline
    text = np.concatenate([text, np.frombuffer(b"\nthe end of the theatre", np.uint8)])
    (d / "c.txt").write_bytes(text.tobytes())
    (d / "list.txt").write_bytes(b"\n".join(mixed_set.mixed_set()))
    return d


def program(argv: list[str], cwd) -> tuple[str, int, int, str, int]:
    out, err = io.BytesIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        stderr, sys.stderr = sys.stderr, err
        try:
            rc = cli.main(list(argv), out=out, device="cpu")
        finally:
            sys.stderr = stderr
    finally:
        os.chdir(here)
    data = out.getvalue()
    return hashlib.sha256(data).hexdigest(), len(data), data.count(b"\n"), err.getvalue(), rc


def reference(argv: list[str], cwd) -> tuple:
    """What the reference says the program prints, as `program` gives it."""
    here = os.getcwd()
    os.chdir(cwd)
    try:
        return tuple(krep_ref.answer(argv))[:5]
    finally:
        os.chdir(here)


ROUTES = {"host": None, "device": "0"}


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    if ROUTES[request.param] is None:
        monkeypatch.delenv("KREP_TPU_HOST_BREAKEVEN", raising=False)
    else:
        monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", ROUTES[request.param])
    return request.param


@pytest.mark.parametrize("argv", [
    ["-c", "the", "c.txt"],
    ["-c", "Sherlock", "c.txt"],
    ["-c", "zzz", "c.txt"],
    ["-o", "the", "c.txt"],
    ["-o", "Sherlock", "c.txt"],
    ["-c", "-f", "list.txt", "c.txt"],
    ["-c", "-e", "the", "-e", "he", "-e", "theatre", "-e", "e t", "c.txt"],
], ids=lambda a: " ".join(a))
def test_corpus_queries(corpus, route, argv):
    assert program(argv, corpus) == reference(argv, corpus)


def test_count_lines_against_a_line_loop():
    """The lockstep automaton against a plain loop over lines, on texts
    of few letters (dense, overlapping members), at several widths."""
    rng = np.random.default_rng(1)
    for _ in range(40):
        text = rng.choice(np.frombuffer(b"ab\nc", np.uint8), int(rng.integers(1, 3000)))
        members = [bytes(rng.choice(list(b"abc"), int(rng.integers(1, 5))).tolist())
                   for _ in range(int(rng.integers(1, 5)))]
        parts = text.tobytes().split(b"\n")
        if text.tobytes().endswith(b"\n"):
            parts = parts[:-1]
        want = sum(any(m in line for m in members) for line in parts)
        for width in (1, 3, 64, 1 << 16):
            assert scan.count_lines(text, members, width=width) == want


def test_file_parts_agree(tmp_path):
    """The worker processes' parts give what one pass over the text gives."""
    text = long_lines(subtitles_corpus.corpus(1 << 20, 9), 2)
    path = tmp_path / "c.txt"
    path.write_bytes(text.tobytes())
    members = list(mixed_set.mixed_set())
    assert scan.count_lines_file(str(path), members, workers=3) == scan.count_lines(text, members)
    sink = io.BytesIO()
    n = scan.only_matching_file(str(path), b"the", b"c.txt", sink, workers=3)
    data, k = scan.only_matching(text, b"the", b"c.txt")
    assert (sink.getvalue(), n) == (data, k)


# -r [--gitignore] -c: the reference's walk against the program's

TREE_SMALL = {"source_files": 600, "dirs": 60, "big_files": 3, "big_max_bytes": 1 << 21,
              "nested_gitignores": 12}


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """A small linux_tree from the recipe's own parameters."""
    d = tmp_path_factory.mktemp("tree")
    linux_tree.make(str(d), dict(linux_tree.PARAMS, **TREE_SMALL), 2**40 + 7)
    return d


@pytest.mark.parametrize("argv", [
    ["-r", "--gitignore", "-c", "PM_RESUME", "linux"],
    ["-r", "-c", "PM_RESUME", "linux"],
    ["-r", "--gitignore", "-c", "PM_RESUME", "linux/"],
    ["-r", "--gitignore", "-c", "struct", "linux"],
    ["-r", "--gitignore", "-c", "PM_RESUMEX", "linux"],
], ids=lambda a: " ".join(a))
def test_tree_queries(small_tree, route, argv):
    assert program(argv, small_tree) == reference(argv, small_tree)


def _write(root: Path, files: dict) -> None:
    """files: relative path -> bytes, or ("link", target)."""
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(data, tuple):
            os.symlink(data[1], p)
        else:
            p.write_bytes(data)


HIT = b"int a;\nPM_RESUME here\nint b;\n"
MISS = b"int a;\nPM_SUSPEND there\n"
BIG = 1 << 20


def _hand_tree(root: Path) -> None:
    _write(root / "t", {
        ".gitignore": b"# a comment\n\n*.txt\n!keep.txt\n  /top.c  \ngen/\n\t!.gitignore\n.*\n*.h\n",
        "a.txt": HIT, "keep.txt": HIT, "top.c": HIT, "plain.c": HIT, "empty.c": b"",
        "unended.c": b"x\nPM_RESUME", "twice.c": b"PM_RESUME PM_RESUME\nPM_RESUME\n",
        ".hidden.c": HIT, ".hiddendir/x.c": HIT, "node_modules/x.c": HIT, "build/x.c": HIT,
        "gen/x.c": HIT, "sub/gen": HIT, "sub/top.c": HIT,
        "sub/.gitignore": b"!*.h\n!a.txt\n", "sub/a.txt": HIT, "sub/b.h": HIT, "b.h": HIT,
        "sub/deeper/c.txt": HIT, "sub/deeper/d.h": MISS,
        "app.min.js": HIT, ".min.js": HIT, "a.MIN.js": HIT, "LOGO.PNG": HIT, "x.o": HIT, ".o": HIT, "a.": HIT, "..o": HIT, "Makefile": MISS,
        "big_nul.c": b"\0" + HIT + b"x" * BIG, "big_late_nul.c": HIT + b"x" * 2000 + b"\0"
        + b"y" * BIG, "small_nul.c": b"\0" + HIT, "exact.c": b"\0" + HIT + b"z" * (BIG - 1 - len(HIT)),
        "link.c": ("link", "plain.c"), "linkdir": ("link", "sub"),
    })


def test_hand_tree_walk(tmp_path):
    """What the reference keeps of a hand-made tree, case by case."""
    _hand_tree(tmp_path)
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        kept = [p for p, _ in tree.walk("t", True)]
        every = [p for p, _ in tree.walk("t", False)]
        control = [p for p, _ in tree.walk("t", True, drop_negations=True)]
    finally:
        os.chdir(here)
    name = lambda ps: {os.path.relpath(p, "t") for p in ps}
    # *.txt then !keep.txt; top.c by its basename at any depth (the '/' cut);
    # gen/ only as a directory; .* after !.gitignore: the last match wins;
    # sub/ re-includes *.h and a.txt below it; hidden files and .min. assets
    # (".min." with its case), directories and skipped extensions (the text
    # from a last dot that does not lead the name), the sniff over 1 MiB, links
    assert name(kept) == {"keep.txt", "plain.c", "empty.c", "unended.c", "twice.c", "sub/gen",
                          "sub/a.txt", "sub/b.h", "sub/deeper/d.h", "a.MIN.js", "a.", "Makefile",
                          "big_late_nul.c", "small_nul.c", "exact.c"}
    assert name(every) == name(kept) | {
        ".gitignore", "a.txt", "top.c", ".hidden.c", ".o", "gen/x.c", "sub/top.c", "sub/.gitignore",
        "b.h", "sub/deeper/c.txt"}
    assert name(control) == name(kept) - {"keep.txt", "sub/a.txt", "sub/b.h", "sub/deeper/d.h"}
    # depth first, in readdir order: a directory's files right after its entry
    subs = [i for i, p in enumerate(every) if p.startswith(os.path.join("t", "sub", ""))]
    assert subs == list(range(subs[0], subs[0] + len(subs)))


@pytest.mark.parametrize("argv", [
    ["-r", "--gitignore", "-c", "PM_RESUME", "t"],
    ["-r", "-c", "PM_RESUME", "t"],
    ["-r", "--gitignore", "-c", "nothing at all", "t"],
], ids=lambda a: " ".join(a))
def test_hand_tree_queries(tmp_path, route, argv):
    """Negation, dir-only lines, a child's .gitignore over its parent's,
    hidden files and directories, skip lists, .min., the NUL sniff over
    1 MiB, symbolic links: the reference prints what the program does."""
    _hand_tree(tmp_path)
    assert program(argv, tmp_path) == reference(argv, tmp_path)


def test_reference_readings_where_the_sources_are_silent(tmp_path):
    """Two readings of the reference's own (tree.py): a name that ends in
    ".min." holds ".min." and is passed over, and a .gitignore line ends at
    '\\n' alone, so a '\\r' inside it stays in its pattern while a
    trailing one is cut. The program reads both otherwise (PERF.md, Open
    questions), so these are held to the reference alone."""
    _write(tmp_path / "t", {".gitignore": b"one\rtwo\n three \r\n", "one": HIT, "two": HIT,
                            "three": HIT, "x.min.": HIT, "y.min": HIT})
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        kept = {os.path.relpath(p, "t") for p, _ in tree.walk("t", True)}
    finally:
        os.chdir(here)
    assert kept == {".gitignore", "one", "two", "y.min"}
    assert tree.gitignore_entries(str(tmp_path / "t")) == [("one\rtwo", False, False),
                                                         ("three", False, False)]
