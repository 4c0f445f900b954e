"""The frozen copies of the recipes against the originals they copy."""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_helpers import REPO  # noqa: E402
from recipes import mixed_set, subtitles_corpus  # noqa: E402

from krep_tpu_torch.tools import bench, bench_hamming  # noqa: E402


def test_corpus_is_the_twins_at_its_seed():
    size = 256 << 10
    assert np.array_equal(subtitles_corpus.corpus(size, 12345), bench.corpus_bytes(size))
    other = subtitles_corpus.corpus(size, 2**31 + 5)
    assert other.shape == (size,) and not np.array_equal(other[:4096], bench.corpus_bytes(4096))


def test_corpus_source_is_the_twins():
    """corpus.c is the twin's, but for the comment that says who builds it."""
    code = lambda p: [ln for ln in open(p).read().split("\n") if not ln.startswith(" *")]
    assert code(REPO / "benchmark" / "recipes" / "corpus.c") == \
        code(REPO / "krep_tpu_torch" / "tools" / "corpus.c")


def test_mixed_set_is_the_twins():
    assert mixed_set.mixed_set() == bench_hamming.mixed_set()
    assert subtitles_corpus.WORDS == bench_hamming.WORDS
