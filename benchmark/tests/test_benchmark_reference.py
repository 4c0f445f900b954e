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

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from recipes import mixed_set, subtitles_corpus  # noqa: E402
from reference import krep_ref, scan  # noqa: E402

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
    here = os.getcwd()
    os.chdir(cwd)
    try:
        return tuple(krep_ref.answer(argv))
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
