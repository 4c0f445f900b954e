"""Wrappers of the hand-written CUDA literal scans (csrc/*_scan.cu).

Port of krep_tpu/ops/pallas_swar.py (`scan_literal`, `scan_shard`,
`scan_multi`, `lines_from_mask`). Four kernels carry them:

  scan_blocks        one CUDA block per 64 KiB of staged text: the match
                     test of one pattern, the 0/1 start mask (or the
                     first-in-line mask of the -c dedup, which the
                     launch's last block finishes across block edges),
                     and one line-accounting summary per block (the TPU
                     kernel's sequential carries become these summaries);
  scan_blocks_multi  the same for up to 64 patterns in one pass: the summed
                     match count, and the union mask and line state, with
                     the shard stats of `scan_shard_multi` (start_limit,
                     prev_word) for the sharded route (parallel/mesh.py),
                     from a filter map, buckets and member words that
                     `multi_tables` builds once per set and
                     `device_multi_tables` keeps on the card;
  lines_blocks       the same summaries from a precomputed 0/1 start mask;
  combine_blocks     one block that folds summaries in text order into the
                     match count, the matched-line count and the shard
                     stats: for the kernels that write rows only (the
                     Hamming kernel's line mode, the byte scan's variants).

scan_blocks, scan_blocks_multi, lines_blocks and bytescan.scan_blocks_bytes
return that fold too, the totals, beside the rows: the launch's last block
folds its own rows (the scan tail, csrc/scan_common.cuh `finish_blocks`),
counting its blocks in a scratch that `tail_scratch` keeps, one per
(device, stream).

On a CUDA tensor each wrapper launches its kernel or raises. On a CPU
tensor it runs the kernel's plain PyTorch version (literal.block_stats,
whose first_line mask is the finished one, as lines.first_line_fixup
finishes block-by-block flags; literal.block_stats_multi,
literal.lines_block_stats, lines.combine_block_stats, which also gives the
totals). `LAUNCHES` (`MASK_LAUNCHES` of them with a start mask,
`FIRST_LINE_LAUNCHES` with mask_kind="first_line", each finishing its mask
in its tail, `SHARD_LAUNCHES` with a start_limit), `MULTI_LAUNCHES`
(`MULTI_SHARD_LAUNCHES` of them in the shard mode), `LINES_LAUNCHES` and
`COMBINE_LAUNCHES` count kernel launches, and `TAIL_FOLDS` the launches
that folded their own totals (the byte scan's too), so a run can show that
it went through the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel import lines
from . import literal
from .literal import BLOCK_BYTES, STAT_WORDS

MAX_PATTERN = 64        # longer patterns go through the prefix filter (engine/search.py)
MAX_PATTERNS = 64       # patterns per scan_blocks_multi pass
TAIL_BYTES = 64         # bytes the kernel reads past the body: m - 1 plus the -w after-byte
NO_LIMIT = 0x7FFFFFF0   # start_limit sentinel: no owned-region restriction

LAUNCHES = 0
MASK_LAUNCHES = 0
FIRST_LINE_LAUNCHES = 0
SHARD_LAUNCHES = 0
MULTI_LAUNCHES = 0
MULTI_SHARD_LAUNCHES = 0
LINES_LAUNCHES = 0
COMBINE_LAUNCHES = 0
TAIL_FOLDS = 0

_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _check_text(text: torch.Tensor, n_blocks: int, tail: int) -> int:
    body = n_blocks * BLOCK_BYTES
    if n_blocks < 1 or text.dim() != 1 or text.shape[0] < body + tail:
        raise ValueError("text must be flat and cover n_blocks * 64 KiB plus the tail")
    if body > (1 << 31):
        raise ValueError("staged arrays are limited to 2 GiB of body")
    return body


def _check_true_len(true_len: int, body: int, start_limit: int | None) -> None:
    """Starts lie in the body. Matches may end in the tail (a shard's
    halo) only where a start_limit within the body bounds the starts."""
    tail = TAIL_BYTES if start_limit is not None and start_limit <= body else 0
    if true_len > body + tail:
        raise ValueError("true_len lies past the staged body")


def tail_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The scan tail's scratch on `device` for the CUDA stream `stream` (a
    handle): its counters and group rows, krep_tail_words() int32 of device
    memory, zeroed once on that stream; the launch's blocks leave the
    counters at zero again. Launches on one stream run one after another;
    launches on two streams use two scratches."""
    key = (device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        from . import _build

        words = _build.library().krep_tail_words()
        scratch = _SCRATCH.setdefault(key, torch.zeros(words, dtype=torch.int32, device=device))
    return scratch


def _tail(device: torch.device):
    """(stream handle, totals, scratch) of a launch with the scan tail on
    `device`'s current stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    totals = torch.empty(STAT_WORDS, dtype=torch.int32, device=device)
    return stream, totals, tail_scratch(device, stream)


def scan_blocks(
    text: torch.Tensor,
    true_len: int,
    n_blocks: int,
    *,
    pattern: bytes,
    case_sensitive: bool = True,
    whole_word: bool = False,
    prev_word: int = 0,
    start_limit: int | None = None,
    want_mask: bool = False,
    mask_kind: str = "starts",
):
    """Per-64 KiB-block summaries (n_blocks, 8) int32 of
    [count, first, trail, lead, has_nl, 0, 0, 0] over the first
    n_blocks * 64 KiB bytes of `text`, the u8 0/1 mask over them (None
    unless want_mask), and the totals, (8,) int32 [count, matched lines,
    trail, lead, has_nl, 0, 0, 0]: the summaries folded in text order
    (lines.combine_block_stats of words 0..4). The mask holds every match
    start, or for mask_kind="first_line" (which needs want_mask) the first
    match of each line, the -c dedup events; word 5 then holds each block's
    lead-flag offset (see literal.block_stats). `text` is flat uint8 and
    holds at least TAIL_BYTES more bytes (the staged zero halo). On a CUDA
    tensor the kernel's last block folds the totals and, for "first_line",
    finishes the mask across block edges, in the same launch."""
    m = len(pattern)
    if not 1 <= m <= MAX_PATTERN:
        raise ValueError(f"pattern length {m} outside 1..{MAX_PATTERN}")
    if mask_kind not in ("starts", "first_line"):
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    first_line = mask_kind == "first_line"
    if first_line and not want_mask:
        raise ValueError('mask_kind="first_line" needs want_mask')
    body = _check_text(text, n_blocks, TAIL_BYTES)
    _check_true_len(true_len, body, start_limit)
    if _device_kind(text) == "cpu":
        stats, mask = literal.block_stats(
            text, true_len, n_blocks, pattern=pattern,
            case_sensitive=case_sensitive, whole_word=whole_word,
            prev_word=prev_word, start_limit=start_limit, want_mask=want_mask,
            mask_kind=mask_kind,
        )
        return stats, mask, lines.combine_block_stats(stats)

    from . import _build

    _check_cuda(text, torch.uint8, "text")
    pat = pattern if case_sensitive else literal.fold_bytes_host(pattern)
    stats = torch.empty((n_blocks, STAT_WORDS), dtype=torch.int32, device=text.device)
    mask = torch.empty(body, dtype=torch.uint8, device=text.device) if want_mask else None
    stream, totals, scratch = _tail(text.device)
    with torch.cuda.device(text.device):
        err = _build.library().krep_scan_blocks(
            text.data_ptr(), n_blocks, pat, m, int(not case_sensitive),
            int(whole_word), int(true_len), int(bool(prev_word)),
            NO_LIMIT if start_limit is None else int(start_limit), int(first_line),
            None if mask is None else mask.data_ptr(), stats.data_ptr(),
            totals.data_ptr(), scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"scan_blocks kernel launch failed: CUDA error {err}")
    global LAUNCHES, MASK_LAUNCHES, FIRST_LINE_LAUNCHES, SHARD_LAUNCHES, TAIL_FOLDS
    LAUNCHES += 1
    TAIL_FOLDS += 1
    MASK_LAUNCHES += want_mask and not first_line
    SHARD_LAUNCHES += start_limit is not None
    FIRST_LINE_LAUNCHES += first_line
    return stats, mask, totals


# Byte layout of the K-pattern kernel's tables (csrc/multi_scan.cu MultiTables).
_T_MAP, _T_WORDS, _T_LEN, _T_LIST, _T_OFF, _T_MULT, _T_PRESENT, MULTI_TABLE_BYTES = (
    0, 4096, 8192, 8256, 8320, 9360, 9376, 9392,
)
MAP_BITS = 15           # filter map bits
BUCKET_BITS = 8         # buckets per prefix length: the top bits of key * bucket multiplier
HASH_MULT = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)  # prefix lengths 1..4
MULT_TRIES = 4096       # bucket multipliers tried per prefix length


def prefix_hash(prefix: bytes, mult: int | None = None) -> int:
    """The kernel's hash of a member's first l = min(m, 4) bytes: their
    little-endian value times `mult` (by default HASH_MULT[l - 1], the
    filter's), mod 2**32."""
    mult = HASH_MULT[len(prefix) - 1] if mult is None else mult
    return int.from_bytes(prefix, "little") * mult & 0xFFFFFFFF


def map_bit(prefix: bytes, joint: bool = True) -> int:
    """The filter map bit of a member's prefix (its first min(m, 4) bytes):
    bit (h >> 17) % 32 of map word w >> 22, where h is the prefix's hash
    and w the hash of its first 3 bytes for a 4-byte prefix in a set with
    prefixes of 3 and of 4 bytes (`joint`: the two lengths share one map
    word per position), else h."""
    h = prefix_hash(prefix)
    w = prefix_hash(prefix[:3]) if len(prefix) == 4 and joint else h
    return (w >> 22) * 32 + (h >> 17) % 32


def bucket_mult(keys) -> int:
    """The bucket multiplier of one prefix length: the first of HASH_MULT's
    constant and MULT_TRIES - 1 fixed odd numbers under which the fewest
    distinct keys share a bucket (the top BUCKET_BITS bits of key * mult,
    mod 2**32); none do where one exists."""
    keys = np.unique(np.asarray(keys, np.uint64))
    rng = np.random.default_rng(len(keys))
    mults = np.concatenate([[HASH_MULT[0]], rng.integers(0, 1 << 31, MULT_TRIES - 1) * 2 + 1])
    b = np.sort((keys[None, :] * mults[:, None].astype(np.uint64) & np.uint64(0xFFFFFFFF))
                >> np.uint64(32 - BUCKET_BITS), axis=1)
    shared = (b[:, 1:] == b[:, :-1]).sum(1)
    return int(mults[int(np.argmin(shared))])


def multi_tables(patterns: tuple[bytes, ...]) -> np.ndarray:
    """The K-pattern kernel's tables for `patterns` (already folded for -i):
    the 2**15-bit filter map (map_bit of each member), the members' 4-byte
    words word-major (word i of member k at [i][k], zero past the member's
    length) and their lengths, each prefix length's bucket multiplier
    (bucket_mult), the member indices sorted by bucket (256 (l - 1) + the
    top 8 bits of key * multiplier) with the buckets' offsets, and the
    prefix lengths the set has (bit l - 1)."""
    buf = np.zeros(MULTI_TABLE_BYTES, np.uint8)
    k = len(patterns)
    plen = [min(len(p), 4) for p in patterns]
    joint = {3, 4} <= set(plen)
    bits = np.zeros(1 << MAP_BITS, bool)
    bits[[map_bit(p[:4], joint) for p in patterns]] = True
    buf[_T_MAP:_T_WORDS] = np.packbits(bits, bitorder="little")
    rows = np.zeros((MAX_PATTERNS, MAX_PATTERN), np.uint8)
    for i, p in enumerate(patterns):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
    buf[_T_WORDS:_T_LEN] = rows.view("<u4").T.copy().view(np.uint8).reshape(-1)
    buf[_T_LEN : _T_LEN + k] = [len(p) for p in patterns]
    keys = [int.from_bytes(p[:n], "little") for p, n in zip(patterns, plen)]
    mults = [bucket_mult([q for q, n in zip(keys, plen) if n == l]) for l in range(1, 5)]
    buf[_T_MULT : _T_MULT + 16] = np.array(mults, "<u4").view(np.uint8)
    nb = 1 << BUCKET_BITS
    bucket = np.array([nb * (n - 1) + (prefix_hash(p[:n], mults[n - 1]) >> (32 - BUCKET_BITS))
                       for p, n in zip(patterns, plen)], np.int64)
    buf[_T_LIST : _T_LIST + k] = np.argsort(bucket, kind="stable")
    buf[_T_OFF : _T_OFF + 4 * nb + 1] = np.concatenate(
        [[0], np.cumsum(np.bincount(bucket, minlength=4 * nb))]
    )
    buf[_T_PRESENT : _T_PRESENT + 4] = np.array([sum(1 << (n - 1) for n in set(plen))],
                                                "<u4").view(np.uint8)
    return buf


def device_multi_tables(patterns, case_sensitive: bool, device) -> torch.Tensor:
    """multi_tables of the set as the kernel sees it (folded for -i), on
    `device`, built and copied once per (folded set, case, device): `-r -c
    -e` launches the kernel once per file."""
    pats = tuple(patterns) if case_sensitive else tuple(literal.fold_bytes_host(p) for p in patterns)
    return _cached_tables(pats, bool(case_sensitive), torch.device(device))


@functools.lru_cache(maxsize=32)
def _cached_tables(patterns: tuple[bytes, ...], case_sensitive: bool,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(multi_tables(patterns)).to(device)


def scan_blocks_multi(
    text: torch.Tensor,
    true_len: int,
    n_blocks: int,
    *,
    patterns: tuple[bytes, ...],
    case_sensitive: bool = True,
    whole_word: bool = False,
    prev_word: int = 0,
    start_limit: int | None = None,
    want_mask: bool = False,
):
    """Per-64 KiB-block summaries (n_blocks, 8) int32 of
    [matches, first, trail, lead, has_nl, 0, 0, 0] of up to 64 patterns in
    one pass — matches summed over the patterns (the Aho-Corasick count),
    the line fields over the union of their starts — the u8 0/1 union
    start mask (None unless want_mask), and the totals, the summaries
    folded in text order as for scan_blocks. `text` as for scan_blocks.
    With a `start_limit` (the shard mode, `MULTI_SHARD_LAUNCHES`), starts
    and the newlines that count lie below it; `prev_word` is the -w flag of
    the byte before the text (see literal.block_stats_multi). The kernel's
    tables come from device_multi_tables."""
    if not 1 <= len(patterns) <= MAX_PATTERNS:
        raise ValueError(f"{len(patterns)} patterns outside 1..{MAX_PATTERNS}")
    if any(not 1 <= len(p) <= MAX_PATTERN for p in patterns):
        raise ValueError(f"pattern length outside 1..{MAX_PATTERN}")
    body = _check_text(text, n_blocks, TAIL_BYTES)
    _check_true_len(true_len, body, start_limit)
    if _device_kind(text) == "cpu":
        stats, mask = literal.block_stats_multi(
            text, true_len, n_blocks, patterns=patterns,
            case_sensitive=case_sensitive, whole_word=whole_word,
            prev_word=prev_word, start_limit=start_limit, want_mask=want_mask,
        )
        return stats, mask, lines.combine_block_stats(stats)

    from . import _build

    _check_cuda(text, torch.uint8, "text")
    tables = device_multi_tables(patterns, case_sensitive, text.device)
    stats = torch.empty((n_blocks, STAT_WORDS), dtype=torch.int32, device=text.device)
    mask = torch.empty(body, dtype=torch.uint8, device=text.device) if want_mask else None
    shard = start_limit is not None
    stream, totals, scratch = _tail(text.device)
    with torch.cuda.device(text.device):
        err = _build.library().krep_scan_blocks_multi(
            text.data_ptr(), n_blocks, tables.data_ptr(), int(not case_sensitive),
            int(whole_word), int(true_len), int(bool(prev_word)),
            int(start_limit) if shard else NO_LIMIT, int(shard),
            None if mask is None else mask.data_ptr(), stats.data_ptr(),
            totals.data_ptr(), scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"scan_blocks_multi kernel launch failed: CUDA error {err}")
    global MULTI_LAUNCHES, MULTI_SHARD_LAUNCHES, TAIL_FOLDS
    MULTI_LAUNCHES += 1
    TAIL_FOLDS += 1
    if shard:
        MULTI_SHARD_LAUNCHES += 1
    return stats, mask, totals


def lines_blocks(text: torch.Tensor, mask: torch.Tensor, n_blocks: int):
    """Per-64 KiB-block summaries (n_blocks, 8) int32 of
    [set mask bytes, first, trail, lead, has_nl, 0, 0, 0] of a u8 0/1 start
    mask over the first n_blocks * 64 KiB bytes of `text`, and the totals,
    (8,) int32 [set mask bytes, matched lines, trail, lead, has_nl, 0, 0,
    0]: the summaries folded in text order, on a CUDA tensor by the
    kernel's last block."""
    body = _check_text(text, n_blocks, 0)
    if mask.dim() != 1 or mask.shape[0] < body or mask.device != text.device:
        raise ValueError("mask must be flat, on the text's device, and cover the body")
    if _device_kind(text) == "cpu":
        stats = literal.lines_block_stats(text, mask, n_blocks)
        return stats, lines.combine_block_stats(stats)

    from . import _build

    _check_cuda(text, torch.uint8, "text")
    _check_cuda(mask, torch.uint8, "mask")
    stats = torch.empty((n_blocks, STAT_WORDS), dtype=torch.int32, device=text.device)
    stream, totals, scratch = _tail(text.device)
    with torch.cuda.device(text.device):
        err = _build.library().krep_lines_blocks(
            text.data_ptr(), mask.data_ptr(), n_blocks, stats.data_ptr(),
            totals.data_ptr(), scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"lines_blocks kernel launch failed: CUDA error {err}")
    global LINES_LAUNCHES, TAIL_FOLDS
    LINES_LAUNCHES += 1
    TAIL_FOLDS += 1
    return stats, totals


def combine_blocks(stats: torch.Tensor) -> torch.Tensor:
    """Fold (B, 8) int32 block summaries in order into (8,) int32:
    [count, matched lines, trail, lead, has_nl, 0, 0, 0], in a launch of
    its own: for the summaries of kernels without the scan tail (the
    Hamming kernel's line mode, bytescan.scan_variant)."""
    if stats.dim() != 2 or stats.shape[1] != STAT_WORDS or stats.shape[0] < 1:
        raise ValueError("stats must be (B, 8) with B >= 1")
    if _device_kind(stats) == "cpu":
        return lines.combine_block_stats(stats)

    from . import _build

    _check_cuda(stats, torch.int32, "stats")
    out = torch.empty(STAT_WORDS, dtype=torch.int32, device=stats.device)
    stream = torch.cuda.current_stream(stats.device).cuda_stream
    with torch.cuda.device(stats.device):
        err = _build.library().krep_combine_blocks(
            stats.data_ptr(), stats.shape[0], out.data_ptr(), stream
        )
    if err:
        raise RuntimeError(f"combine_blocks kernel launch failed: CUDA error {err}")
    global COMBINE_LAUNCHES
    COMBINE_LAUNCHES += 1
    return out
