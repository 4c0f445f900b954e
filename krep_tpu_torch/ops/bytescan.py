"""The byte-per-thread literal scan and its cost-attribution variants.

Port of krep_tpu/ops/pallas_scan.py (`scan_literal`, the v1 byte-per-lane
kernel of the JAX package's `pallas` backend) and of the kernel variants
of tools/bench_kernel.py (`variant_kernel`, `run_variant`). One CUDA
source carries both, csrc/byte_scan.cu:

  scan_blocks_bytes  one CUDA block per 64 KiB of staged text: the match
                     test of one pattern of 1..MAX_PATTERN bytes with -i and
                     -w, the u8 start mask, one line-accounting summary per
                     block (the TPU kernel's sequential carries become these
                     summaries), and their fold, the totals, from the
                     launch's last block (swar.TAIL_FOLDS);
  scan_variant       the same kernel cut down to attribute its cost
                     (VARIANTS): "passthrough" sums the body bytes,
                     "compares_only" counts matches, "lines_only" and "full"
                     count matches and matched lines (one body, as in the
                     TPU tool); no -i, -w or mask; rows only, which
                     run_variant folds with swar.combine_blocks.

On a CUDA tensor each wrapper launches its kernel or raises. On a CPU
tensor it runs the kernel's plain PyTorch version (block_stats_bytes,
variant_stats_plain). `LAUNCHES` (`MASK_LAUNCHES` of them with a mask) and
`VARIANT_LAUNCHES[mode]` count kernel launches.
"""

from __future__ import annotations

import torch

from ..parallel import lines
from . import literal, swar
from .literal import BLOCK_BYTES, STAT_WORDS

MAX_PATTERN = 4096     # pallas_scan.py:248: the 32-row halo
HALO_BYTES = 4096      # the kernel reads this far past the body: the staged halo
VARIANTS = ("passthrough", "compares_only", "lines_only", "full")

LAUNCHES = 0
MASK_LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)


def _check(text: torch.Tensor, true_len: int, n_blocks: int, m: int) -> int:
    if not 1 <= m <= MAX_PATTERN:
        raise ValueError(f"pattern length {m} outside 1..{MAX_PATTERN}")
    body = swar._check_text(text, n_blocks, HALO_BYTES)
    if not 0 <= true_len <= body:
        raise ValueError("true_len lies outside the staged body")
    return body


def _device_pattern(pattern: bytes, device: torch.device) -> torch.Tensor:
    """The pattern's bytes on the device: the kernel copies them from device
    memory into shared memory."""
    return torch.frombuffer(bytearray(pattern), dtype=torch.uint8).to(device)


def block_stats_bytes(
    text: torch.Tensor, true_len: int, n_blocks: int, *, pattern: bytes,
    case_sensitive: bool = True, whole_word: bool = False, want_mask: bool = False,
):
    """Plain twin of the byte scan: (n_blocks, 8) int32 block summaries
    [count, first, trail, lead, has_nl, 0, 0, 0], each block summarised as
    if it began on a closed line, and the u8 0/1 start mask over the body
    (None unless want_mask). A match starts at or before true_len - m; the
    -w after-byte is read from the text even past true_len, and newlines
    count over the whole body, as pallas_scan.py reads them."""
    if not 1 <= len(pattern) <= MAX_PATTERN:
        raise ValueError(f"pattern length {len(pattern)} outside 1..{MAX_PATTERN}")
    return literal.block_stats(
        text, true_len, n_blocks, pattern=pattern, case_sensitive=case_sensitive,
        whole_word=whole_word, want_mask=want_mask,
    )


def scan_blocks_bytes(
    text: torch.Tensor, true_len: int, n_blocks: int, *, pattern: bytes,
    case_sensitive: bool = True, whole_word: bool = False, want_mask: bool = False,
):
    """The byte scan of the first n_blocks * 64 KiB bytes of staged `text`
    (flat uint8 holding HALO_BYTES more: the staged halo): (n_blocks, 8)
    int32 summaries, as block_stats_bytes, the u8 0/1 start mask (None
    unless want_mask) and the totals, the summaries folded in text order
    (see swar.scan_blocks)."""
    body = _check(text, true_len, n_blocks, len(pattern))
    if swar._device_kind(text) == "cpu":
        stats, mask = block_stats_bytes(
            text, true_len, n_blocks, pattern=pattern, case_sensitive=case_sensitive,
            whole_word=whole_word, want_mask=want_mask,
        )
        return stats, mask, lines.combine_block_stats(stats)
    pat = pattern if case_sensitive else literal.fold_bytes_host(pattern)
    stats, mask, totals = _launch(text, true_len, n_blocks, _device_pattern(pat, text.device),
                                  len(pat), int(not case_sensitive), int(whole_word), 0,
                                  body if want_mask else 0)
    global LAUNCHES, MASK_LAUNCHES
    LAUNCHES += 1
    MASK_LAUNCHES += want_mask
    swar.TAIL_FOLDS += 1
    return stats, mask, totals


def _launch(text, true_len, n_blocks, dev_pattern, m, icase, wword, variant, mask_bytes):
    """One launch: (stats, mask, totals); the scan (variant 0) with the
    scan tail, a variant with rows only (totals None)."""
    from . import _build

    swar._check_cuda(text, torch.uint8, "text")
    stats = torch.empty((n_blocks, STAT_WORDS), dtype=torch.int32, device=text.device)
    mask = torch.empty(mask_bytes, dtype=torch.uint8, device=text.device) if mask_bytes else None
    if variant == 0:
        stream, totals, scratch = swar._tail(text.device)
    else:
        stream, totals, scratch = torch.cuda.current_stream(text.device).cuda_stream, None, None
    with torch.cuda.device(text.device):
        err = _build.library().krep_byte_scan(
            text.data_ptr(), n_blocks, None if dev_pattern is None else dev_pattern.data_ptr(),
            m, icase, wword, int(true_len), variant,
            None if mask is None else mask.data_ptr(), stats.data_ptr(),
            None if totals is None else totals.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"byte_scan kernel launch failed: CUDA error {err}")
    return stats, mask, totals


def variant_stats_plain(text: torch.Tensor, true_len: int, n_blocks: int, *, mode: str,
                        pattern: bytes = b"the") -> torch.Tensor:
    """Plain twin of a variant: (n_blocks, 8) int32 summaries. passthrough:
    word 0 is the block's byte sum; compares_only: word 0 the block's match
    count; lines_only, full: the summaries of block_stats_bytes (case
    sensitive, no -w)."""
    body = n_blocks * BLOCK_BYTES
    if mode == "passthrough":
        stats = torch.zeros((n_blocks, STAT_WORDS), dtype=torch.int32, device=text.device)
        stats[:, 0] = text[:body].view(n_blocks, BLOCK_BYTES).sum(1, dtype=torch.int32)
        return stats
    stats, _ = block_stats_bytes(text, true_len, n_blocks, pattern=pattern)
    if mode == "compares_only":
        stats[:, 1:] = 0
    return stats


def scan_variant(text: torch.Tensor, true_len: int, n_blocks: int, *, mode: str,
                 pattern: bytes = b"the") -> torch.Tensor:
    """One variant's (n_blocks, 8) int32 summaries over staged `text` (see
    variant_stats_plain): the kernel on a CUDA tensor, the plain version on
    a CPU one."""
    if mode not in VARIANTS:
        raise ValueError(f"unknown variant {mode!r}: expected one of {', '.join(VARIANTS)}")
    _check(text, true_len, n_blocks, len(pattern))
    if swar._device_kind(text) == "cpu":
        return variant_stats_plain(text, true_len, n_blocks, mode=mode, pattern=pattern)
    dev_pattern = None if mode == "passthrough" else _device_pattern(pattern, text.device)
    stats, _, _ = _launch(text, true_len, n_blocks, dev_pattern, len(pattern), 0, 0,
                          1 + VARIANTS.index(mode), 0)
    VARIANT_LAUNCHES[mode] += 1
    return stats


def run_variant(text: torch.Tensor, true_len: int, n_blocks: int, *, mode: str,
                pattern: bytes = b"the") -> torch.Tensor:
    """tools/bench_kernel.py's run_variant: the variant's (2,) int32 result,
    [count, lines] (passthrough: [the int32 byte sum, which wraps, 0];
    compares_only: [count, 0]), folded by swar.combine_blocks."""
    return swar.combine_blocks(scan_variant(text, true_len, n_blocks, mode=mode,
                                            pattern=pattern))[:2]
