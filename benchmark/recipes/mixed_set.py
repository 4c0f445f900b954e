"""A pattern list for `-f`: the bench twin's 64 mixed members, frozen.

A copy of krep_tpu_torch/tools/bench_hamming.py's `mixed_set` (after
bench.py:417-430, config 3c): members of 4-20 bytes, one to three words of
WORDS joined by spaces and cut, some over 13 bytes, drawn with `seed` (the
twin's is 777). Written one member a line, with no newline at the end.

    make(dest, {"members": 64, "name": "list64.txt"}, seed) -> {"list": path}
"""

from __future__ import annotations

import os

import numpy as np

from .subtitles_corpus import WORDS


def mixed_set(seed: int = 777, k: int = 64) -> tuple[bytes, ...]:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        ws = [WORDS[int(i)] for i in rng.integers(0, len(WORDS), int(rng.integers(1, 4)))]
        p = b" ".join(ws)[: int(rng.integers(4, 21))]
        if len(p) >= 4 and p not in out:
            out.append(p)
    return tuple(out)


def make(dest: str, params: dict, seed: int) -> dict:
    path = os.path.join(dest, params["name"])
    with open(path, "wb") as f:
        f.write(b"\n".join(mixed_set(seed, int(params["members"]))))
    return {"list": path}
