"""Time the byte scan's cost-attribution variants on a CUDA card.

    python -m krep_tpu_torch.tools.bench_kernel [size_mb]

Port of tools/bench_kernel.py's main(): a-z text from default_rng(0)
(default 256 MiB), pattern "the", each variant of csrc/byte_scan.cu
(ops/bytescan.VARIANTS: passthrough, compares_only, lines_only, full) run
once and checked against its plain version on the card, then timed with
CUDA events. Each line gives the variant's milliseconds, its GB/s and its
bound: the body bytes read once over 3.35 TB/s (the H100 SXM's HBM3 rate).
passthrough is printed beside torch.sum(text, dtype=torch.int32), one
PyTorch call computing the same wrapped sum. Exits 1 without a card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import bytescan, dispatch
from ..parallel import lines

HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them (else
    torch's device name), for every timing line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[:1]
    return out[0] if out else torch.cuda.get_device_name(0)


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of `reps` calls of fn, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv: list[str] | None = None, reps: int = 20) -> int:
    args = sys.argv[1:] if argv is None else argv
    size = int(args[0]) << 20 if args else 1 << 28
    if not torch.cuda.is_available():
        sys.stderr.write("bench_kernel: needs a CUDA device\n")
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    data = np.random.default_rng(0).integers(97, 123, size, dtype=np.uint8)
    st = dispatch.stage(data, dev)
    text, n, nb = st.u8, st.true_len, st.n_blocks
    body = nb * bytescan.BLOCK_BYTES
    bound_ms = 1e3 * body / HBM_BYTES_PER_S
    print(f"{torch.cuda.get_device_name(0)}: {size >> 20} MiB of a-z, pattern 'the', "
          f"{nb} blocks", flush=True)
    ok = True
    for mode in bytescan.VARIANTS:
        t0 = time.perf_counter()
        got = bytescan.run_variant(text, n, nb, mode=mode, pattern=b"the").tolist()
        first_s = time.perf_counter() - t0
        plain = bytescan.variant_stats_plain(text, n, nb, mode=mode, pattern=b"the")
        want = lines.combine_block_stats(plain)[:2].tolist()
        ok &= got == want
        ms = event_ms(lambda: bytescan.run_variant(text, n, nb, mode=mode, pattern=b"the"), reps)
        print(f"{mode}: first call {first_s:.2f} s count={got[0]} lines={got[1]} "
              f"(plain {want}, equal={got == want})", flush=True)
        print(f"  {ms:.4f} ms -> {size / ms / 1e6:.1f} GB/s; bound {bound_ms:.4f} ms (bytes)",
              flush=True)
        if mode == "passthrough":
            lib = int(torch.sum(text[:body], dtype=torch.int32))
            lib_ms = event_ms(lambda: torch.sum(text[:body], dtype=torch.int32), reps)
            print(f"  torch.sum(text, dtype=torch.int32): {lib_ms:.4f} ms, sum {lib} "
                  f"(equal={lib == got[0]})", flush=True)
            ok &= lib == got[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
