"""Time the single-pattern word scans (csrc/swar_scan.cu, csrc/byte_scan.cu)
on a CUDA card.

    python -m krep_tpu_torch.tools.bench_scan [size_mb]

Two texts of size_mb MiB (default 1024): the config-1 corpus recipe of
bench.py (lines of 3-8 words of its vocabulary, seed 12345) and a-z text
from default_rng(0) with a newline every 4,099 bytes. The K=1 scan
(swar.scan_blocks) in its count, -i -w count, start-mask, shard (a start
limit 12,345 bytes before the end, prev_word 1) and first_line instances
for m = 1, 3, 5, 17 and 64; the byte scan (bytescan.scan_blocks_bytes)
count and mask for m = 3, 65, 1000 and 4096; the byte scan's four
variants. Patterns of more than 5 bytes are cut from the text at a line
start. Each case is held once to its plain version (literal.block_stats,
bytescan.block_stats_bytes, bytescan.variant_stats_plain; first_line
finished across blocks in its own launch), then timed with CUDA events beside its
bound (bytes moved once over 3.35 TB/s). Each line gives the card's name
and power limit. Exits 1 without a card or when a result differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import bytescan, dispatch, literal, swar
from ..parallel import lines
from .bench_hamming import corpus
from .bench_kernel import card_name, event_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
LIMIT_BACK = 12_345


def a_to_z(size: int) -> np.ndarray:
    text = np.random.default_rng(0).integers(97, 123, size, dtype=np.uint8)
    text[::4099] = 10
    return text


def k1_cases(src: np.ndarray, body: int):
    """(label, pattern, scan_blocks keywords, true_len or None, bytes moved)."""
    nl = int(np.flatnonzero(src[5000:6_000_000] == 10)[3]) + 5001
    limit = body - LIMIT_BACK
    for m in (1, 3, 5, 17, 64):
        pat = {1: b"e", 3: b"the", 5: b"quick"}.get(m) or bytes(src[nl : nl + m])
        yield f"m={m} count", pat, {}, None, body
        yield f"m={m} -i -w count", pat, dict(case_sensitive=False, whole_word=True), None, body
        yield f"m={m} mask", pat, dict(want_mask=True), None, 2 * body
        yield (f"m={m} shard", pat, dict(prev_word=1, start_limit=limit), limit + m - 1,
               body - LIMIT_BACK)
        yield (f"m={m} first_line", pat, dict(want_mask=True, mask_kind="first_line"), None,
               2 * body)


def main(argv: list[str] | None = None, reps: int = 10) -> int:
    args = sys.argv[1:] if argv is None else argv
    size = int(args[0]) << 20 if args else 1 << 30
    if not torch.cuda.is_available():
        sys.stderr.write("bench_scan: needs a CUDA device\n")
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_name()
    ok = True
    for label, src in (("config-1 corpus", corpus(size)), ("a-z", a_to_z(size))):
        st = dispatch.stage(src, dev)
        body = st.n_blocks * literal.BLOCK_BYTES
        for name, pat, kw, tl, nbytes in k1_cases(src, body):
            tl = st.true_len if tl is None else tl
            kw = dict(kw, pattern=pat)
            stats, mask, totals = swar.scan_blocks(st.u8, tl, st.n_blocks, **kw)
            pstats, pmask = literal.block_stats(st.u8, tl, st.n_blocks, **kw)
            same = (torch.equal(stats, pstats) and (mask is None or torch.equal(mask, pmask))
                    and torch.equal(totals, lines.combine_block_stats(pstats)))
            ms = event_ms(lambda: swar.scan_blocks(st.u8, tl, st.n_blocks, **kw), reps)
            ok &= same
            print(f"{label}, scan_blocks {name}: {ms:.4f} ms, bound "
                  f"{1e3 * (nbytes + 32 * st.n_blocks) / HBM_BYTES_PER_S:.4f} ms, "
                  f"{int(stats[:, 0].sum())} matches, equal to plain={same} [{card}]", flush=True)
            del stats, mask, pstats, pmask
        nl = int(np.flatnonzero(src[7000:6_000_000] == 10)[1]) + 7001
        for m in (3, 65, 1000, 4096):
            pat = b"the" if m == 3 else bytes(src[nl : nl + m])
            for want_mask in (False, True):
                kw = dict(pattern=pat, want_mask=want_mask)
                stats, mask, totals = bytescan.scan_blocks_bytes(st.u8, st.true_len,
                                                                 st.n_blocks, **kw)
                pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len, st.n_blocks, **kw)
                same = (torch.equal(stats, pstats) and (mask is None or torch.equal(mask, pmask))
                        and torch.equal(totals, lines.combine_block_stats(pstats)))
                ms = event_ms(lambda: bytescan.scan_blocks_bytes(st.u8, st.true_len, st.n_blocks,
                                                                 **kw), reps)
                ok &= same
                nbytes = (2 if want_mask else 1) * body + bytescan.HALO_BYTES
                print(f"{label}, byte scan m={m} {'mask' if want_mask else 'count'}: {ms:.4f} ms, "
                      f"bound {1e3 * (nbytes + 32 * st.n_blocks) / HBM_BYTES_PER_S:.4f} ms, "
                      f"{int(stats[:, 0].sum())} matches, equal to plain={same} [{card}]",
                      flush=True)
                del stats, mask, pstats, pmask
        for mode in bytescan.VARIANTS:
            got = bytescan.scan_variant(st.u8, st.true_len, st.n_blocks, mode=mode)
            same = torch.equal(got, bytescan.variant_stats_plain(st.u8, st.true_len, st.n_blocks,
                                                                  mode=mode))
            ms = event_ms(lambda: bytescan.scan_variant(st.u8, st.true_len, st.n_blocks,
                                                        mode=mode), reps)
            ok &= same
            print(f"{label}, variant {mode}: {ms:.4f} ms, equal to plain={same} [{card}]",
                  flush=True)
        del st
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
