"""State carried across from the JAX package.

krep has no weights: its state is the staged text and the pattern
constants. `staged_from_reference` wraps the JAX package's staged host
bytes (krep_tpu.ops.dispatch.StagedText._np, a numpy array) as the port's
StagedText, so both packages scan identical padded bytes.
`mxu_tables_from_reference` turns the JAX package's Hamming tables
(krep_tpu.ops.mxu_multi.build_tables, each array as numpy) into the port's
device tables, the "weights" of the multi-pattern route.
`phase_words` re-derives the per-phase word constants of the TPU kernel
(krep_tpu/ops/pallas_swar.py:116-130), for a word-parallel kernel.
"""

from __future__ import annotations

import numpy as np

from .ops import dispatch, mxu


def staged_from_reference(np_buffer: np.ndarray, n: int, device=None,
                          true_len: int | None = None) -> dispatch.StagedText:
    """The port's StagedText over a copy of `np_buffer`, the JAX package's
    padded staging bytes for an n-byte text. With `true_len`, the port's
    with_len(true_len) view of it, the twin of a JAX StagedText.with_len
    view, whose bytes past true_len may be live text."""
    buf = np.asarray(np_buffer, dtype=np.uint8)
    if buf.shape != (dispatch.bucket_size(n),) or (true_len is None and buf[n:].any()):
        raise ValueError("buffer is not a staged layout of n bytes with a zero tail")
    dev = dispatch.resolve_device(device)
    host = dispatch.host_buffer(buf.shape[0], dev)
    host.numpy()[:] = buf
    st = dispatch.StagedText(host, n, dev)
    return st if true_len is None else st.with_len(true_len)


def mxu_tables_from_reference(tables, device=None) -> mxu.HammingTables:
    """The port's HammingTables from krep_tpu's build_tables output
    (G1, nb1, G2, nb2, lens, bitmask, kp_s, qs), arrays as numpy or jax
    arrays."""
    G1, nb1, G2, nb2, lens, bitmask, kp_s, qs = tables
    arrays = [None if a is None else np.asarray(a) for a in (G1, nb1, G2, nb2, lens, bitmask)]
    return mxu.device_tables((*arrays, int(kp_s), tuple(qs)), dispatch.resolve_device(device))


def phase_words(pat: bytes, p: int) -> list[tuple[int, int, int]]:
    """(t, mask, value) little-endian u32 word constants for matches that
    start at byte phase p (0..3) of a word: a match at byte 4e+p holds iff
    for every entry (word[e+t] & mask) == value."""
    m = len(pat)
    out = []
    for t in range((p + m + 3) // 4):
        mask = val = 0
        for b in range(4):
            i = 4 * t + b - p
            if 0 <= i < m:
                mask |= 0xFF << (8 * b)
                val |= pat[i] << (8 * b)
        if mask:
            out.append((t, mask, val))
    return out

