"""Driver contract of the port: the twin of the repository's
`__graft_entry__.py`.

entry() — the K=1 scan step of the flagship path (`krep -c the`: the scan
kernel's block summaries and start mask, folded by the combine kernel) and
its arguments, staged on the device: `fn(*args)` runs it.

dryrun_multichip(n) — runs parallel.mesh.dryrun over an n-device mesh:
sharded counts, line counts, positions, -w at shard edges, a fused
multi-pattern step, the long-pattern prefix filter and the Hamming count,
checked against a numpy reference.

Both take `device` (default: $KREP_TORCH_DEVICE, else "cuda").
"""

from __future__ import annotations

import numpy as np

from .ops import dispatch
from .parallel import mesh


def entry(device=None):
    dev = dispatch.resolve_device(device)
    n = 128 * 1024
    rng = np.random.default_rng(0)
    staged = dispatch.stage(rng.integers(97, 123, n, dtype=np.uint8), dev)

    def fn(staged):
        return dispatch.scan_literal_staged(
            staged, pattern=b"the", case_sensitive=True, whole_word=False,
            want_mask=True,
        )

    return fn, (staged,)


def dryrun_multichip(n_devices: int, device=None) -> None:
    mesh.dryrun(n_devices, device)


if __name__ == "__main__":
    fn, args = entry()
    totals, mask, _ = fn(*args)
    print("entry ok:", totals[:2].tolist(), tuple(mask.shape))
    dryrun_multichip(len(mesh.devices(dispatch.resolve_device())))
    print("dryrun ok")
