"""Time the scan tail and the lines kernel of one source tree, for A/B
comparisons of two trees on one card.

    python krep_tpu_torch/tools/bench_tail.py TREE_ROOT LABEL

TREE_ROOT is a checkout that holds a krep_tpu_torch package (this one,
or an older one unpacked with `git archive`); its kernels build into
TREE_ROOT/build/ab_build. Run it as a script, not with -m, so that the
package comes from TREE_ROOT. On 1 GiB of the config-1 corpus recipe
(bench.py, seed 12345) it times with CUDA events (3 rounds of 20 calls,
the median): the kernels of a `-c the` count (the scan and the
standalone combine_blocks on a tree whose scans return no totals, the
scan with its tail otherwise), the same on the 1 GiB slab (24,576
blocks, the last 8,192 past the start limit), the 16-literal count of
BASELINE config 3, the lines kernel on those literals' 1 GiB union mask,
the standalone combine_blocks at 16,384 and 24,576 rows, on a tree with
the tail the count instance with and without its tail (five interleaved
pairs, the median of each; "the", at 16,384 and 24,576 rows, and m = 17),
and the scan instances that the tail's code
moves most in ptxas: the K=1 scan at m = 17, the byte scan at m = 65 and
the K-pattern scan's shard instance with the 64 variants of BASELINE
config 3b (start limit 12,345 bytes before the end, as the tools
bench_scan and bench_multi run them), each one launch, the kernel
alone. Every totals vector returned is held to lines.combine_block_stats
of its rows. Prints one JSON line with the card's name and power limit
and the ptxas register counts of the build.
"""

import json
import os
import subprocess
import sys


def main(root: str, label: str) -> int:
    root = os.path.abspath(root)
    sys.path[0] = root
    os.environ["KREP_TORCH_BUILD_DIR"] = os.path.join(root, "build", "ab_build")

    import numpy as np
    import torch

    from krep_tpu_torch.ops import _build, bytescan, dispatch, swar
    from krep_tpu_torch.parallel import lines
    from krep_tpu_torch.tools.bench_hamming import PATTERNS_16, corpus, variant_set

    assert swar.__file__.startswith(root), swar.__file__
    if not torch.cuda.is_available():
        print("bench_tail: no CUDA card", file=sys.stderr)
        return 1
    gib = 1 << 30
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    lib = _build.library()
    tail = hasattr(swar, "TAIL_FOLDS")  # the scans return their totals

    def ms(fn, reps=20, rounds=3):
        out = []
        for _ in range(rounds):
            fn()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / reps)
        return sorted(out)[rounds // 2]

    text = corpus(gib)
    st = dispatch.stage(text, dev)
    slab = dispatch.stage(np.concatenate([text, text[:3]]), dev, true_len=gib + 2)
    assert (st.n_blocks, slab.n_blocks) == (16384, 24576)
    res = {"tree": label, "card": card}

    def rows(s, **kw):
        out = swar.scan_blocks(s.u8, s.true_len, s.n_blocks, pattern=b"the", **kw)
        if tail:
            assert torch.equal(out[2], lines.combine_block_stats(out[0]))
        return out[0]

    def count_query(s, **kw):
        if tail:
            return lambda: swar.scan_blocks(s.u8, s.true_len, s.n_blocks, pattern=b"the", **kw)
        return lambda: swar.combine_blocks(
            swar.scan_blocks(s.u8, s.true_len, s.n_blocks, pattern=b"the", **kw)[0])

    rows16 = rows(st)
    rows24 = rows(slab, start_limit=gib)
    res["-c the kernels"] = ms(count_query(st))
    res["slab kernels"] = ms(count_query(slab, start_limit=gib))
    pats = tuple(PATTERNS_16)

    def multi(want_mask=False):
        return swar.scan_blocks_multi(st.u8, st.true_len, st.n_blocks, patterns=pats,
                                      want_mask=want_mask)

    mask = multi(True)[1]
    if tail:
        res["16-literal -c kernels"] = ms(lambda: multi(), reps=10)
        stats, totals = swar.lines_blocks(st.u8, mask, st.n_blocks)
        assert torch.equal(totals, lines.combine_block_stats(stats))
        res["lines kernel (its tail included)"] = ms(
            lambda: swar.lines_blocks(st.u8, mask, st.n_blocks))
    else:
        res["16-literal -c kernels"] = ms(lambda: swar.combine_blocks(multi()[0]), reps=10)
        stats = swar.lines_blocks(st.u8, mask, st.n_blocks)
        res["lines kernel"] = ms(lambda: swar.lines_blocks(st.u8, mask, st.n_blocks))
        res["lines kernel + combine_blocks"] = ms(
            lambda: swar.combine_blocks(swar.lines_blocks(st.u8, mask, st.n_blocks)))
    res["lines matched"] = int(lines.combine_block_stats(stats)[1])
    res["combine_blocks 16384"] = ms(lambda: swar.combine_blocks(rows16), reps=200)
    res["combine_blocks 24576"] = ms(lambda: swar.combine_blocks(rows24), reps=200)
    nl = int(np.flatnonzero(text[5000:6_000_000] == 10)[3]) + 5001  # bench_scan's patterns
    p17 = bytes(text[nl : nl + 17])
    if tail:
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = swar.tail_scratch(dev, stream)
        tot = torch.empty(8, dtype=torch.int32, device=dev)
        for s, n_rows, pat, limit in ((st, 16384, b"the", swar.NO_LIMIT),
                                      (slab, 24576, b"the", gib),
                                      (st, "16384 m=17", p17, swar.NO_LIMIT)):
            out = torch.empty((s.n_blocks, 8), dtype=torch.int32, device=dev)

            def launch(with_tail, s=s, out=out, pat=pat, limit=limit):
                err = lib.krep_scan_blocks(
                    s.u8.data_ptr(), s.n_blocks, pat, len(pat), 0, 0, int(s.true_len), 0,
                    int(limit), 0, None, out.data_ptr(), tot.data_ptr() if with_tail else None,
                    scratch.data_ptr() if with_tail else None, stream)
                assert err == 0, err

            w, wo = [], []
            for _ in range(5):
                w.append(ms(lambda: launch(True), rounds=1))
                wo.append(ms(lambda: launch(False), rounds=1))
            w, wo = sorted(w)[2], sorted(wo)[2]
            assert torch.equal(tot, lines.combine_block_stats(out))
            res[f"count {n_rows} with tail"] = w
            res[f"count {n_rows} without tail"] = wo
            res[f"tail {n_rows}"] = w - wo
    for name, pat in (("K=1 m=17 count", p17), ("K=1 m=3 count", b"the")):
        res[name] = ms(lambda pat=pat: swar.scan_blocks(st.u8, st.true_len, st.n_blocks,
                                                        pattern=pat))
    pat = bytes(text[nl : nl + 65])
    res["byte scan m=65 count"] = ms(
        lambda: bytescan.scan_blocks_bytes(st.u8, st.true_len, st.n_blocks, pattern=pat))
    v64, limit = variant_set(64), st.n_blocks * 65536 - 12_345
    tl = min(st.true_len, limit + max(map(len, v64)) - 1)
    res["K=64 count shard"] = ms(lambda: swar.scan_blocks_multi(
        st.u8, tl, st.n_blocks, patterns=v64, prev_word=1, start_limit=limit), reps=10)
    log = _build.build().with_suffix(".log").read_text()
    regs = [ln for ln in log.splitlines() if "Used" in ln]
    res["registers"] = sorted({int(x.split("Used ")[1].split()[0]) for x in regs})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
