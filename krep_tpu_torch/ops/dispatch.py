"""Host→device staging, the staged scan, and the mask readback.

Port of krep_tpu/ops/dispatch.py. The staging contract is unchanged
(dispatch.py:56-81): texts pad into geometric buckets of 128-byte rows,
R rows (a multiple of 512, so a whole number of 64 KiB blocks) plus a
32-row (4 KiB) zero halo, with zeros past `true_len`. The CUDA kernels read
up to 64 bytes into that halo.

There is one route per device: a CUDA tensor goes through the CUDA kernels
(ops/swar.py, ops/mxu.py, ops/bytescan.py), a CPU tensor through their
plain PyTorch versions.

KREP_TPU_BACKEND (the JAX package's knob, `backend()`) picks the
single-literal kernel: `auto`, `swar`, `xla` and any other value take the SWAR scan
(csrc/swar_scan.cu), `pallas` the byte-per-thread scan (csrc/byte_scan.cu,
the port of krep_tpu/ops/pallas_scan.py). The byte scan runs where
krep_tpu's `_scan_literal_staged` runs pallas_scan (dispatch.py:267-280):
a start mask or no mask, with no start_limit and no prev_word, which is the
single-array route, the long-pattern prefix filter and the -r position and
`-c -o` batches. The slab loop (start_limit, prev_word), the -r -c
`first_line` batches and the mesh keep the SWAR kernel. krep_tpu sends its
slab loop to a numpy host scan under a non-SWAR backend
(engine/search.py:307-319); the port does not, since that would put a CPU
route on a machine with a card.

Staging a text of two chunks (CHUNK_BYTES) or more is a pipeline: host
threads fill the pinned buffer chunk by chunk, and each chunk's copy to
the card is issued as soon as it is filled, so the copy of one chunk runs
while the threads fill the next. A shorter text is copied whole, then
sent whole.

The host's parts of a staged scan are spans of utils/profiling.py:
`stage.pin` (the pinned buffer acquired), `stage.copy` (the text copied
into it; on the pipeline, the whole fill loop, with each chunk's
`stage.h2d` inside it), `stage.h2d` (the copy to the card issued),
`device.wait` (the host blocked on the card's results, `to_host`) and
`readback.expand` (the mask's groups or bits expanded into offsets on the
host). The counters `stage.pipelined` and `stage.chunks` count the
stagings that took the pipeline and the chunks they issued.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures

import numpy as np
import torch

from ..utils import profiling
from . import bytescan, swar
from .literal import BLOCK_BYTES

TILE_ROWS = 512        # R is a multiple of this: 64 KiB of text
HALO_ROWS = 32         # 4 KiB forward zero halo
LANES = 128
HALO_BYTES = HALO_ROWS * LANES
GROUP_BYTES = BLOCK_BYTES  # mask readback groups: 64 KiB of text each
CHUNK_BYTES = 16 << 20  # the staging pipeline's chunk: a whole number of blocks
FILL_WORKERS = 8        # the most host threads that fill chunks


def backend() -> str:
    """$KREP_TPU_BACKEND (default "auto"): "pallas" selects the byte scan,
    any other value the SWAR scan, as krep_tpu's `_scan_literal_staged`
    falls through to its default scan for any value it does not name."""
    return os.environ.get("KREP_TPU_BACKEND", "auto")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a search runs on: `device`, else $KREP_TORCH_DEVICE, else
    "cuda". Asking for CUDA where there is none raises."""
    dev = torch.device(
        device if device is not None else os.environ.get("KREP_TORCH_DEVICE", "cuda")
    )
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "krep_tpu_torch: CUDA device requested but torch.cuda.is_available() "
                "is False (pass device='cpu' or set KREP_TORCH_DEVICE=cpu)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"krep_tpu_torch: unsupported device {dev}")
    return dev


def row_bucket(rows: int) -> int:
    """Smallest row bucket ≥ rows from {512, 1024, 1536, 2048, 3072, ...}:
    powers of two plus midpoints, all multiples of TILE_ROWS."""
    if rows <= TILE_ROWS:
        return TILE_ROWS
    p = 1 << int(rows - 1).bit_length()
    mid = (p // 2) * 3 // 2
    if rows <= mid and mid % TILE_ROWS == 0:
        return mid
    return p


def bucket_size(n: int) -> int:
    rows = -(-n // LANES)
    return LANES * (row_bucket(rows) + HALO_ROWS)


class StagedText:
    """One padded host buffer (pinned when the device is CUDA) and its
    device copy `u8`, flat uint8 in the staged layout; `n` = `true_len` is
    the real byte count. On the CPU `u8` is the host buffer itself.
    `tail_zero`: every byte at and past true_len is zero, as fresh staging
    leaves them (a with_len view may say otherwise)."""

    def __init__(self, host: torch.Tensor, n: int, device: torch.device):
        if host.shape[0] != bucket_size(n):
            raise ValueError("host buffer is not in the staged layout for n")
        with profiling.span("stage.h2d"):
            if device.type == "cuda":
                u8 = host.to(device, non_blocking=True)
                profiling.count("h2d.bytes", host.shape[0])
            else:
                u8 = host
        self._bind(host, n, u8)

    def _bind(self, host: torch.Tensor, n: int, u8: torch.Tensor) -> None:
        self._host = host
        self._np = host.numpy()
        self.n = n
        self.true_len = n
        self.tail_zero = True
        self.u8 = u8

    @property
    def n_blocks(self) -> int:
        return (self.u8.shape[0] - HALO_BYTES) // BLOCK_BYTES

    def with_len(self, n: int, tail_zero: bool = False) -> "StagedText":
        """A view of the same buffers (host and device, staged once) with
        another length n (krep_tpu's StagedText.with_len, which its bench
        uses to time chained lengths). tail_zero: the caller asserts that
        the bytes at and past n are zero; otherwise they may be live text,
        which the Hamming route bounds only with strict=True."""
        if not 0 <= n <= self.n_blocks * BLOCK_BYTES:
            raise ValueError("with_len: n lies outside the staged body")
        other = object.__new__(StagedText)
        other.__dict__.update(self.__dict__)
        other.n = other.true_len = n
        other.tail_zero = tail_zero
        return other


def as_u8(text) -> np.ndarray:
    if isinstance(text, (bytes, bytearray, memoryview)):
        return np.frombuffer(text, dtype=np.uint8)
    return np.asarray(text, dtype=np.uint8)


def host_buffer(size: int, device: torch.device) -> torch.Tensor:
    """A host buffer of `size` bytes for `device`: pinned (torch's caching
    host allocator) for a CUDA device."""
    with profiling.span("stage.pin"):
        return torch.empty(size, dtype=torch.uint8, pin_memory=device.type == "cuda")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor's values on the host, as numpy: the host waits for
    the card to finish what the tensor depends on, and the copy."""
    with profiling.span("device.wait"):
        a = t.cpu().numpy()
    profiling.count("d2h.bytes", a.nbytes)
    return a


_POOL: tuple[int, futures.ThreadPoolExecutor] | None = None  # (pid, pool)
_POOL_LOCK = threading.Lock()


def _fill_pool() -> futures.ThreadPoolExecutor:
    """The process's pool of fill threads, made at its first use (and
    anew in a forked child, whose copy of the parent's pool has no
    threads)."""
    global _POOL
    pid = os.getpid()
    with _POOL_LOCK:
        if _POOL is None or _POOL[0] != pid:
            workers = min(FILL_WORKERS, len(os.sched_getaffinity(0)))
            _POOL = (pid, futures.ThreadPoolExecutor(workers, "krep-stage"))
        return _POOL[1]


def _fill(hv: np.ndarray, buf: np.ndarray, a: int, b: int) -> None:
    """Bytes [a, b) of the staged layout: the text where it reaches, zeros
    past it."""
    n = buf.shape[0]
    if a < n:
        hv[a:min(b, n)] = buf[a:b]
    hv[max(a, n):b] = 0


def _device_buffer(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Where the pipeline puts the staged text: a new buffer on a card, the
    host buffer itself on the CPU."""
    if dev.type == "cuda":
        return torch.empty(host.shape[0], dtype=torch.uint8, device=dev)
    return host


def _stage_chunks(buf: np.ndarray, host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """The staging pipeline: the pool fills `host` in chunks of CHUNK_BYTES
    (the last one takes the remainder), and this thread issues each
    chunk's copy to the card on the current stream as soon as it is
    filled. Returns the device buffer (`host` itself on the CPU); the
    kernels launched after it on the stream see every chunk."""
    size = host.shape[0]
    u8 = _device_buffer(host, dev)
    send = u8 is not host
    hv = host.numpy()
    k = size // CHUNK_BYTES
    cuts = [i * CHUNK_BYTES for i in range(k)] + [size]
    pool = _fill_pool()
    with profiling.span("stage.copy"):
        fills = [pool.submit(_fill, hv, buf, a, b) for a, b in zip(cuts, cuts[1:])]
        try:
            for a, b, f in zip(cuts, cuts[1:], fills):
                f.result()
                if send:
                    with profiling.span("stage.h2d"):
                        u8[a:b].copy_(host[a:b], non_blocking=True)
        finally:
            for f in fills:  # on an error, no fill outlives the call
                f.cancel()
            futures.wait(fills)
    if send:
        profiling.count("h2d.bytes", size)
    profiling.count("stage.pipelined")
    profiling.count("stage.chunks", k)
    return u8


def stage(
    text, device: str | torch.device | None = None, true_len: int | None = None
) -> StagedText:
    """Stage `text` for `device`. `true_len` (default: all of it) bounds
    where matches may end; bytes past it stay in the buffer for the -w
    after-check, as the slab loop needs."""
    buf = as_u8(text)
    n = buf.shape[0]
    if n >= (1 << 31):
        # single-array offsets are int32; bigger inputs go through the slab
        # loop (engine/search.py)
        raise NotImplementedError(
            "single-array staging is limited to 2 GiB; use the slab path"
        )
    dev = resolve_device(device)
    host = host_buffer(bucket_size(n), dev)
    profiling.count("stage.bytes", host.shape[0])
    if n >= 2 * CHUNK_BYTES:
        st = object.__new__(StagedText)
        st._bind(host, n, _stage_chunks(buf, host, dev))
    else:
        with profiling.span("stage.copy"):
            _fill(host.numpy(), buf, 0, host.shape[0])
        st = StagedText(host, n, dev)
    if true_len is not None:
        st.true_len = true_len
        st.tail_zero = true_len >= n
    return st


def scan_literal_staged(
    staged: StagedText, *, pattern, case_sensitive, whole_word, want_mask,
    prev_word: int = 0, start_limit: int | None = None, mask_kind: str = "starts",
):
    """Fused literal scan of a staged text, asynchronous on a CUDA device.
    Returns device tensors (totals, mask, group_counts): totals is (8,)
    int32 [count, matched lines, trail, lead, has_nl, 0, 0, 0], mask the
    u8 0/1 mask over the staged body (None unless want_mask) of match
    starts, or for mask_kind="first_line" of the -c dedup events (the first
    match of each line), group_counts the per-64 KiB match counts (the scan
    kernel's block counts). Under KREP_TPU_BACKEND=pallas a starts mask (or
    none) with no start_limit and no prev_word runs the byte scan, else the
    SWAR scan (module docstring); both give the same summaries."""
    if (backend() == "pallas" and mask_kind == "starts" and start_limit is None
            and not prev_word):
        stats, mask, totals = bytescan.scan_blocks_bytes(
            staged.u8, staged.true_len, staged.n_blocks, pattern=pattern,
            case_sensitive=case_sensitive, whole_word=whole_word, want_mask=want_mask,
        )
        return totals, mask, stats[:, 0]
    stats, mask, totals = swar.scan_blocks(
        staged.u8, staged.true_len, staged.n_blocks, pattern=pattern,
        case_sensitive=case_sensitive, whole_word=whole_word,
        prev_word=prev_word, start_limit=start_limit, want_mask=want_mask,
        mask_kind=mask_kind,
    )
    return totals, mask, stats[:, 0]


def scan_multi_staged(
    staged: StagedText, *, patterns, case_sensitive, whole_word, want_mask,
):
    """Fused scan of up to 64 patterns (the K-pattern twin of
    scan_literal_staged). Returns device tensors (totals, mask,
    group_counts): totals (8,) int32 [matches summed over the patterns,
    matched lines of their union, trail, lead, has_nl, 0, 0, 0], the u8
    0/1 union start mask (None unless want_mask), and the per-64 KiB match
    counts, which are non-zero exactly where the union mask has a set byte
    (all the readback asks of them)."""
    stats, mask, totals = swar.scan_blocks_multi(
        staged.u8, staged.true_len, staged.n_blocks, patterns=tuple(patterns),
        case_sensitive=case_sensitive, whole_word=whole_word, want_mask=want_mask,
    )
    return totals, mask, stats[:, 0]


def _pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """0/1 byte mask → bit-packed uint8, 8 text positions per byte
    (position 8j+b = bit b of byte j): 8x less device→host transfer for
    DENSE masks (positions-at-scale -o queries)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (mask.view(-1, 8) << shifts).sum(1, dtype=torch.uint8)


def _starts_via_packed_bits(mask: torch.Tensor, n: int) -> np.ndarray:
    """Dense-mask readback: pack on the device, transfer n/8 bytes, expand
    on the host (native ctz walk)."""
    from ..native import runtime as _native

    packed = to_host(_pack_mask_bits(mask))
    with profiling.span("readback.expand"):
        return _native.bits_to_starts(packed, n)


def starts_from_device_mask(
    mask: torch.Tensor, n: int, group_counts: torch.Tensor | None = None
) -> np.ndarray:
    """Match-start offsets (< n, sorted int64) from a 0/1 u8 mask without
    transferring the whole of it: per-64 KiB group counts come back first
    (tiny; the scan kernel's block counts when given), then only the groups
    that hold matches are gathered on the device and copied out. Dense
    masks are bit-packed on the device and transferred at n/8 bytes."""
    size = mask.shape[0]
    if size % GROUP_BYTES or size < GROUP_BYTES * 4:
        whole = to_host(mask[:n])
        with profiling.span("readback.expand"):
            return np.flatnonzero(whole).astype(np.int64)
    G = size // GROUP_BYTES
    m2 = mask.view(G, GROUP_BYTES)
    if group_counts is None:
        group_counts = m2.sum(1, dtype=torch.int32)
    nz = np.flatnonzero(to_host(group_counts))
    if len(nz) == 0:
        return np.zeros(0, np.int64)
    if len(nz) > G // 2:
        return _starts_via_packed_bits(mask, n)
    sel = to_host(m2.index_select(0, torch.from_numpy(nz).to(mask.device)))
    with profiling.span("readback.expand"):
        rows, cols = np.nonzero(sel)
        starts = nz[rows].astype(np.int64) * GROUP_BYTES + cols
        return starts[starts < n]
