"""Time the K-pattern scan (csrc/multi_scan.cu) on a CUDA card.

    python -m krep_tpu_torch.tools.bench_multi [size_mb]

Two texts of size_mb MiB (default 1024): the config-1 corpus recipe of
bench.py (lines of 3-8 words of its vocabulary, seed 12345; a match every
few bytes for these sets) and a-z text from default_rng(0) (few matches).
Sets: bench.py's 16 literals (config 3) and its 64 eight-byte variants
(config 3b), each through all 16 instances of the kernel (count and mask,
with and without -i and -w, unbounded and in the shard mode with a start
limit inside a thread's span); then the count and mask instances on two
sets that stress the verify (common_prefix_set, collision_set). Each case
is held once to literal.block_stats_multi, then timed with CUDA events.
Each line gives the card's name and power limit. Exits 1 without a card
or when a result differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import dispatch, literal, swar
from ..parallel import lines
from .bench_hamming import PATTERNS_16, WORDS, corpus, variant_set
from .bench_kernel import card_name, event_ms

LIMIT_BACK = 12_345  # the shard cases' start limit: this far before the body's end


def common_prefix_set(prefix: bytes = b"the ") -> tuple[bytes, ...]:
    """64 members that share one 4-byte prefix, each `prefix` and a
    prefix of a vocabulary word (or nothing): on the corpus every "the "
    is a candidate whose bucket holds all 64, and several match."""
    out = [prefix]
    for j in range(1, 9):
        for w in WORDS:
            p = prefix + w[:j]
            if p not in out:
                out.append(p)
    return tuple(out[:64])


def _words4(alphabet: bytes) -> np.ndarray:
    """Every 4-byte string over `alphabet`, as little-endian uint64 keys."""
    a = np.frombuffer(alphabet, np.uint8).astype(np.uint64)
    g = np.stack(np.meshgrid(a, a, a, a, indexing="ij"), -1).reshape(-1, 4)
    return g[:, 0] | g[:, 1] << np.uint64(8) | g[:, 2] << np.uint64(16) | g[:, 3] << np.uint64(24)


def _hash(keys: np.ndarray, n: int) -> np.ndarray:
    """swar.prefix_hash of n-byte keys."""
    return keys * np.uint64(swar.HASH_MULT[n - 1]) & np.uint64(0xFFFFFFFF)


def _map_bit(keys: np.ndarray, n: int) -> np.ndarray:
    """swar.map_bit of n-byte keys (n = 3 or 4) in a set with prefixes of 3
    and of 4 bytes."""
    h = _hash(keys, n)
    w = _hash(keys & np.uint64(0xFFFFFF), 3) if n == 4 else h
    return (w >> np.uint64(22)) * np.uint64(32) + (h >> np.uint64(17)) % np.uint64(32)


def collision_set() -> tuple[bytes, ...]:
    """A set built to collide in the kernel's filter map on the corpus:
    "the "; a 4-letter member of the map bit of "the " and one whose map
    bit a 4-byte window of the corpus sets; a 3-letter member whose map bit
    such a window sets (lengths 3 and 4 share map words), so those windows
    are candidates whose buckets do not hold the member; and two plain
    members."""
    four = _words4(b"abcdefghijklmnopqrstuvwxyz")
    the = int.from_bytes(b"the ", "little")
    bit4 = _map_bit(four, 4)
    twin = int(four[(bit4 == swar.map_bit(b"the ")) & (four != the)][0])
    text = b" ".join(WORDS) + b" "
    grams = np.array(sorted({int.from_bytes(text[i : i + 4], "little")
                             for i in range(len(text) - 3)}), np.uint64)
    bits = _map_bit(grams, 4)
    alias = int(four[np.isin(bit4, bits) & ~np.isin(four, grams)][0])
    three = np.unique(four & np.uint64(0xFFFFFF))
    cross = int(three[np.isin(_map_bit(three, 3), bits)][0])
    return (b"the ", twin.to_bytes(4, "little") + b"x", alias.to_bytes(4, "little"),
            cross.to_bytes(3, "little"), b"fox", b"lazy dog")


def instances():
    """The kernel's 16 template instances as scan_blocks_multi arguments:
    (label, case_sensitive, whole_word, want_mask, shard)."""
    for shard in (False, True):
        for mask in (False, True):
            for cs, ww in ((True, False), (False, False), (True, True), (False, True)):
                label = ("mask" if mask else "count") + ("" if cs else " -i") + \
                    (" -w" if ww else "") + (" shard" if shard else "")
                yield label, cs, ww, mask, shard


def check_and_time(st, pats, cs, ww, mask, shard, reps: int) -> tuple[bool, float, int]:
    """One instance on a staged text: equal to the plain version (rows,
    mask and the scan tail's totals)? Its
    CUDA-event ms and its match count."""
    limit = st.n_blocks * literal.BLOCK_BYTES - LIMIT_BACK if shard else None
    tl = st.true_len if limit is None else min(st.true_len, limit + max(map(len, pats)) - 1)
    kw = dict(patterns=pats, case_sensitive=cs, whole_word=ww, want_mask=mask,
              prev_word=int(shard), start_limit=limit)
    stats, m, totals = swar.scan_blocks_multi(st.u8, tl, st.n_blocks, **kw)
    pstats, pm = literal.block_stats_multi(st.u8, tl, st.n_blocks, **kw)
    same = (torch.equal(stats, pstats) and (m is None or torch.equal(m, pm))
            and torch.equal(totals, lines.combine_block_stats(pstats)))
    del pm
    ms = event_ms(lambda: swar.scan_blocks_multi(st.u8, tl, st.n_blocks, **kw), reps)
    return same, ms, int(stats[:, 0].sum())


def main(argv: list[str] | None = None, reps: int = 5) -> int:
    args = sys.argv[1:] if argv is None else argv
    size = int(args[0]) << 20 if args else 1 << 30
    if not torch.cuda.is_available():
        sys.stderr.write("bench_multi: needs a CUDA device\n")
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_name()
    ok = True
    for label, data in (("config-1 corpus", corpus(size)),
                        ("a-z", np.random.default_rng(0).integers(97, 123, size, dtype=np.uint8))):
        st = dispatch.stage(data, dev)
        del data
        cases = [(name, pats, inst) for name, pats in (("16 literals", tuple(PATTERNS_16)),
                                                       ("64 variants", variant_set(64)))
                 for inst in instances()]
        cases += [(name, pats, inst) for name, pats in (("common prefix", common_prefix_set()),
                                                        ("collision", collision_set()))
                  for inst in instances() if inst[0] in ("count", "mask")]
        for name, pats, (mode, cs, ww, mask, shard) in cases:
            same, ms, n = check_and_time(st, pats, cs, ww, mask, shard, reps)
            ok &= same
            print(f"{label}, {name} (K={len(pats)}), {mode}: {ms:.4f} ms, {n} matches, "
                  f"equal to plain={same} [{card}]", flush=True)
        del st
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
