"""Time the Hamming kernel (csrc/hamming_scan.cu) on a CUDA card.

    python -m krep_tpu_torch.tools.bench_hamming [size_mb]

Two texts of size_mb MiB (default 1024): the config-1 corpus recipe of
bench.py (lines of 3-8 words of its vocabulary, seed 12345; a match every
few bytes for these sets) and a-z text from default_rng(0) (few matches).
Two sets: bench.py's 64 eight-byte variants (config 3b) and its 64 mixed
4-20 byte members (config 3c, two windows). For each text and set, the
count instance, the mask instance, want_lines and strict (on
with_len(n - 17)) are held once to mxu.hamming_scan_plain on the card,
then timed with CUDA events. Each line gives the card's name and power
limit. Exits 1 without a card or when a result differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import dispatch, mxu
from .bench_kernel import card_name, event_ms

WORDS = (
    b"the quick brown fox jumps over a lazy dog and then some more words "
    b"it was time for Sherlock to breathe deeply in the theatre"
).split()
PATTERNS_16 = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy", b"dog",
               b"Sherlock", b"time", b"words", b"some", b"then", b"deeply", b"was", b"more"]


def variant_set(k: int) -> tuple[bytes, ...]:
    """bench.py:362-371 (config 3b at k=64): PATTERNS_16, then numbered
    variants of at most 8 bytes."""
    out, i = [], 0
    while len(out) < k:
        w, r = PATTERNS_16[i % 16], i // 16
        p = (w[:5] + str(r).encode() if r else w)[:8]
        if p not in out:
            out.append(p)
        i += 1
    return tuple(out)


def mixed_set() -> tuple[bytes, ...]:
    """bench.py:417-430 (config 3c): 64 members of 4-20 bytes, some over 13
    bytes (the Hamming kernel's second window)."""
    rng = np.random.default_rng(777)
    out = []
    while len(out) < 64:
        ws = [WORDS[int(i)] for i in rng.integers(0, len(WORDS), int(rng.integers(1, 4)))]
        p = b" ".join(ws)[: int(rng.integers(4, 21))]
        if len(p) >= 4 and p not in out:
            out.append(p)
    return tuple(out)


def corpus(size: int, seed: int = 12345) -> np.ndarray:
    """bench.py's config-1 corpus recipe (bench.py:38-60), vectorised, as
    chip_smoke.py writes it: lines of 3-8 vocabulary words joined by
    spaces."""
    rng = np.random.default_rng(seed)
    tokens = [w + b" " for w in WORDS]
    lens = np.array([len(t) for t in tokens], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pool = np.frombuffer(b"".join(tokens), np.uint8)
    parts, total = [], 0
    while total < size:
        k = rng.integers(3, 9, 1 << 20)
        idx = rng.integers(0, len(WORDS), int(k.sum()))
        wl = lens[idx]
        ends = np.cumsum(wl)
        wid = np.repeat(np.arange(len(idx)), wl)
        chunk = pool[offs[idx][wid] + np.arange(int(ends[-1])) - (ends - wl)[wid]]
        chunk[ends[np.cumsum(k) - 1] - 1] = 10
        parts.append(chunk)
        total += chunk.shape[0]
    return np.concatenate(parts)[:size]


def main(argv: list[str] | None = None, reps: int = 5) -> int:
    args = sys.argv[1:] if argv is None else argv
    size = int(args[0]) << 20 if args else 1 << 30
    if not torch.cuda.is_available():
        sys.stderr.write("bench_hamming: needs a CUDA device\n")
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_name()
    ok = True
    for label, data in (("config-1 corpus", corpus(size)),
                        ("a-z", np.random.default_rng(0).integers(97, 123, size, dtype=np.uint8))):
        st = dispatch.stage(data, dev)
        del data
        view = st.with_len(st.n - 17)
        for sname, pats in (("64 variants", variant_set(64)), ("64 mixed", mixed_set())):
            tables = mxu.device_tables(mxu.build_tables(pats, True), dev)
            modes = {
                "count": (st, {}),
                "mask": (st, dict(want_mask=True)),
                "want_lines": (st, dict(want_lines=True)),
                "strict": (view, dict(strict=True, true_len=view.true_len)),
            }
            for mode, (s, kw) in modes.items():
                got = mxu.hamming_scan(s.u8, s.n_blocks, tables, **kw)
                want = mxu.hamming_scan_plain(s.u8, s.n_blocks, tables, **kw)
                same = torch.equal(got[0], want[0]) and (
                    got[1] is None or torch.equal(got[1], want[1]))
                ok &= same
                ms = event_ms(lambda: mxu.hamming_scan(s.u8, s.n_blocks, tables, **kw), reps)
                counts = got[0][:, 0] if mode == "want_lines" else got[0]
                print(f"{label}, {sname}, {mode}: {ms:.4f} ms, {int(counts.sum())} matches, "
                      f"equal to plain={same} [{card}]", flush=True)
        del st, view
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
