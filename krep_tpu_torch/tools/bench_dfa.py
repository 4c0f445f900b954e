"""Time the dense-DFA walk (csrc/dfa_scan.cu) and the first_line scan of
one tree of the port on a CUDA card, through the wrappers every tree has,
for an A/B of two trees in one call.

    python krep_tpu_torch/tools/bench_dfa.py ROOT LABEL

ROOT is the root of the tree to time (its krep_tpu_torch is imported and
its kernels built into its own build/); run it on a `git archive` of each
tree, in turns (parent, change, change, parent), to compare them on one
card. Times with CUDA events, over the wrappers the route calls:
`ac.dfa_walk` (count and mask; with the tree's packed table built once
where its dfa_walk takes one) on bench.py's 100 variants at 16 MiB,
64 MiB and 1 GiB of the config-1 corpus (bench.py's recipe, seed 12345)
and with -i at 1 GiB, and on 1,024 patterns whose automaton comes near the
65,536-state cap at 16 MiB and 1 GiB; and `swar.scan_blocks(first_line)`
(with the fix-up, whichever way the tree does it) on the corpus staged as
the walker's full `-r` batch (1,536 blocks) and as 1,000 blocks. Each
line gives LABEL, the result (emissions or flags, to compare across the
trees), the card's name and power limit.
"""

from __future__ import annotations

import inspect
import subprocess
import sys

import numpy as np


def near_cap_set(text: np.ndarray, seed: int = 5) -> tuple[bytes, ...]:
    """chip_smoke.py's near-cap set: 1,000 random 64-byte a-z strings and 24
    pieces of 8-64 bytes cut from `text`, lower-cased."""
    rng = np.random.default_rng(seed)
    pats = [bytes(rng.integers(97, 123, 64, dtype=np.uint8)) for _ in range(1000)]
    for at in rng.integers(0, len(text) - 64, 24):
        pats.append(bytes(text[at : at + int(rng.integers(8, 65))]).lower())
    return tuple(pats)


def main(root: str, label: str) -> int:
    sys.path.insert(0, root)
    import torch

    from krep_tpu_torch.ops import _build, ac, dispatch, swar
    from krep_tpu_torch.tools.bench_hamming import corpus, variant_set

    if not torch.cuda.is_available():
        print("bench_dfa: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _build.build()

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    text = corpus(1 << 30)
    takes_packed = "packed" in inspect.signature(ac.dfa_walk).parameters
    sets = {"100 variants": variant_set(100), "near the cap": near_cap_set(text[: 64 << 20])}
    tables = {}
    for name, pats in sets.items():
        for cs in (True, False):
            if name == "near the cap" and not cs:
                continue
            built = ac.build_dense_ac(list(pats), cs)
            table, emit = (torch.from_numpy(a).to(dev) for a in built)
            extra = dict(packed=ac.pack_dense_table(*built, cs).to(dev)) if takes_packed else {}
            tables[(name, cs)] = (table, emit, max(map(len, pats)), extra)
    shapes = {16 << 20: [("100 variants", True), ("near the cap", True)],
              64 << 20: [("100 variants", True)],
              1 << 30: [("100 variants", True), ("100 variants", False), ("near the cap", True)]}
    for size, keys in shapes.items():
        st = dispatch.stage(text[:size], dev)
        for name, cs in keys:
            table, emit, maxlen, extra = tables[(name, cs)]
            for want_mask in (False, True):
                def run():
                    return ac.dfa_walk(st.u8, st.true_len, st.n_blocks, table, emit,
                                       maxlen=maxlen, case_sensitive=cs, want_mask=want_mask,
                                       **extra)
                total = int(run()[0])
                ms = cuda_ms(run, 100 if size < 1 << 30 else 20)
                print(f"{label}: dfa_walk {'mask' if want_mask else 'count'} {name} cs={cs} "
                      f"{size >> 20} MiB: {ms:.4f} ms, {total} emissions [{card}]", flush=True)
        del st
    full = dispatch.stage(text[:67_121_740], dev)  # the walker's full batch: 1,536 blocks
    raw = torch.zeros(1000 * 65536 + dispatch.HALO_BYTES, dtype=torch.uint8)
    raw[: 1000 * 65536] = torch.from_numpy(text[: 1000 * 65536].copy())
    for what, u8, true_len, n_blocks in (("1,536 blocks", full.u8, full.true_len, full.n_blocks),
                                         ("1,000 blocks", raw.to(dev), 1000 * 65536, 1000)):
        def scan():
            return swar.scan_blocks(u8, true_len, n_blocks, pattern=b"the", want_mask=True,
                                    mask_kind="first_line")
        flags = int(scan()[1].sum())
        ms = cuda_ms(scan, 200)
        print(f"{label}: scan_blocks first_line {what}: {ms:.4f} ms, {flags} flags, "
              f"{n_blocks} blocks [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
