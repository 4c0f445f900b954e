// Single-literal scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the K=1 modes of the TPU kernel krep_tpu/ops/pallas_swar.py
// `_make_kernel` (built at :396, launched by `_scan_raw` :883, pallas_call
// at :961): the all-starts match of one 1-64 byte pattern with the -i fold
// and the -w word boundaries, the match count, the matched-line count
// (the -c dedup: a line counts once, at its first match), the 0/1 start
// mask or the first-in-line mask, and the shard statistics of `scan_shard`
// (first-in-line count, trail, lead, has_nl) bounded by `start_limit` and
// `prev_word`.
//
// What bounds it on the card: the bytes (one pass reads the staged text, n
// bytes, and with a mask writes n mask bytes: 0.32 / 0.64 ms per GiB at
// 3.35 TB/s) and, nearly as much, the instructions per byte. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (python -m krep_tpu_torch.tools.bench_scan):
// the count takes 0.49 ms per GiB where the read alone takes 0.35, each
// masked word compare per position about 0.14 ms more (m up to 8: 0.63 ms),
// -i -w 0.82 ms, the start mask 0.75 ms. The first design walked each
// thread's 256 shared-memory bytes one at a time, entered a compare loop
// with an early exit at every byte equal to the pattern's first (on English
// text some lane of every warp is in that loop at nearly every step),
// tested -w, the mask and the limit per byte at run time and wrote the mask
// 4 bytes at a time with the lanes of a warp 256 bytes apart: 3.3 ms per
// GiB, 6.7 with the mask. This design is the
// word scan of scan_common.cuh (word_scan_block), as the TPU kernel compares
// whole words (`_phase_words`, pallas_swar.py:116):
//   * each warp walks its 8 KiB in strides of 512 bytes, lane l holding
//     bytes 16l..16l+15 in registers, loaded straight from global memory
//     two strides ahead (coalesced, no shared-memory copy, no barrier); the
//     next lane's first words and the previous lane's last byte come by
//     shuffle;
//   * every start position is a funnel-shifted window compared under a
//     byte mask: one compare up to 4 pattern bytes, two up to 8; a longer
//     pattern takes those 8 bytes as a branch-free filter, and the warp
//     verifies its candidates 32 at a time from a queue (verify_long), so
//     dense candidates do not serialise it (a 12-byte filter, one compare
//     more per position, cost more than the verify it saves on English);
//   * -w is a bit word: the word flags of the lane's bytes (made one stride
//     ahead), shifted by 1 and by m, tested directly on bytes (not the TPU
//     kernel's SWAR borrow, which drops matches after "_^");
//   * lines: a lane's newlines are a bit word too; two ballots per stride
//     give each lane the state entering it, and the carry of one add (as
//     fold_bits) gives its first-in-line flags; count is a popc;
//   * the mask: each lane stores its 16 flags as 16 0/1 bytes, one uint4,
//     so a warp stores 512 contiguous bytes;
//   * the pattern-length class, -w and the mask kind (none, starts,
//     first_line) are template arguments: 18 instances, picked by
//     krep_scan_blocks, whose hot loop tests none of them. -i folds each
//     loaded word (a block-uniform test); the limits are one warp-uniform
//     test per stride, and only the stride that holds the last start or
//     start_limit masks its hit and newline words. A block wholly past
//     start_limit writes zeros and stops.
//
// The TPU kernel carries the open-line flag, the -w previous-byte flag and
// the shard stats across its sequential grid in scratch memory. CUDA
// blocks run in no order, so each block emits a summary, and the launch's
// last block folds them in text order with the algebra of
// LineCountCombiner.push (krep_tpu/parallel/mesh.py:135-143): the scan
// tail of scan_common.cuh (finish_blocks, whose note has the counter's
// argument), which writes the totals beside the rows. A second launch
// used to do that fold (combine_blocks_kernel below, one block of 1,024
// threads: 0.045 ms at 16,384 rows, against a 0.0002 ms bound); it stays
// for the summaries of kernels without the tail (the Hamming kernel's line
// mode, the byte scan's cost-attribution variants). The -w flag is a
// direct read of the previous byte. The folded summary is the
// matched-line count and, unchanged, the shard stats of the slab loop.
//
// The -c dedup mask (mask kind first_line, the batched `-r -c` path of
// krep_tpu/io/batch.py) is made exact in three steps, none relying on the
// order blocks run in: inside a warp the state entering each lane comes
// from the ballots, so its flags are exact as if the warp's span began on
// a closed line; a warp clears its lead flag (its first match, when at or
// before its first newline: the only flag the entering state can change)
// when an earlier warp of the block leaves a matched line open, read from
// the warps' summaries in shared memory, and the block stores the offset of
// its own lead flag in stats word 5 (-1 if none); the launch's last block,
// once the tail has every row, clears the lead flag of each block whose
// entering line already has a match (scan_common.cuh finish_blocks' kLeads,
// an exclusive scan of the rows' line-state maps; the rows and the totals
// do not change). A second launch used to do that step (first_line_fixup,
// one thread per block walking back over the rows: 0.0214 ms at the
// 1,536-block batch, PERF.md).

#include <string.h>

#include "scan_common.cuh"

namespace {

constexpr int kCombineThreads = 1024;
constexpr int kPatWords = kMaxPattern / 4 + 2;  // zero words past the longest pattern

struct Pattern {
  uint32_t w[kMaxPattern / 4];  // little-endian words, zero past m
};

template <int kLen, bool kWord, int kMask>
__global__ void __launch_bounds__(kThreads)
scan_blocks_kernel(const uint8_t* __restrict__ text, Pattern pat, int m, int icase, int true_len,
                   int prev_word, int start_limit, uint8_t* __restrict__ mask,
                   int* __restrict__ stats, int* __restrict__ totals, int* scratch,
                   uint8_t* fix_mask) {
  __shared__ WordScanShared<kPatWords> sh;
  if (threadIdx.x == 0) {  // constant indices: the argument stays in the constant bank
#pragma unroll
    for (int i = 0; i < kPatWords; ++i) sh.pat[i] = i < kMaxPattern / 4 ? pat.w[i] : 0u;
  }
  __syncthreads();
  word_scan_block<kLen, kWord, kMask, true>(
      WordScanArgs{text, m, icase, true_len, prev_word, start_limit, mask, stats}, sh);
  finish_blocks<true, kMask == kFirstLineMask>(stats, totals, scratch, sh.warp_sums, fix_mask);
}

__global__ void __launch_bounds__(kCombineThreads)
combine_blocks_kernel(const int* __restrict__ stats, int nblocks, int* __restrict__ out) {
  __shared__ Summary warp_sums[kCombineThreads / 32];
  const int t = threadIdx.x;
  const int per = (nblocks + kCombineThreads - 1) / kCombineThreads;
  const int lo = min(t * per, nblocks);
  const int hi = min(lo + per, nblocks);
  Summary s = {0, 0, 0, 0, 0};
  for (int b = lo; b < hi; ++b) {
    const int* r = stats + b * kStatWords;
    const Summary y = {r[0], r[1], r[2], r[3], r[4]};
    s = combine(s, y);
  }
  s = warp_fold(s);
  if ((t & 31) == 0) warp_sums[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    Summary b = warp_sums[0];
    for (int w = 1; w < kCombineThreads / 32; ++w) b = combine(b, warp_sums[w]);
    out[0] = b.count;
    out[1] = b.first;
    out[2] = b.trail;
    out[3] = b.lead;
    out[4] = b.has_nl;
    out[5] = out[6] = out[7] = 0;
  }
}


using ScanKernel = void (*)(const uint8_t*, Pattern, int, int, int, int, int, uint8_t*, int*, int*,
                           int*, uint8_t*);

#define KREP_SCAN(L, W)                                                             \
  scan_blocks_kernel<L, W, kNoMask>, scan_blocks_kernel<L, W, kStartMask>,          \
      scan_blocks_kernel<L, W, kFirstLineMask>
// (length class, -w, mask kind) -> instance: (3 * (2 * class + word) + kind)
const ScanKernel kScanInstances[18] = {
    KREP_SCAN(kLen4, false),  KREP_SCAN(kLen4, true),    KREP_SCAN(kLen8, false),
    KREP_SCAN(kLen8, true),   KREP_SCAN(kLenLong, false), KREP_SCAN(kLenLong, true),
};
#undef KREP_SCAN

}  // namespace

// Per-block summaries of nblocks * 64 KiB of staged text, and their fold.
// `text` must hold nblocks * 65536 + 64 readable bytes (the staged 4 KiB
// zero halo covers the tail) and be 16-byte aligned; `pattern` holds m
// bytes, already folded for -i; `mask` (nullable, 16-byte aligned) receives
// one 0/1 byte per text byte, every match start, or with `first_line` the
// first-in-line flags: `first_line` 1, finished across blocks by the tail
// (which needs `totals`), or 2, each block's as if it began on a closed
// line (the mask before that step, for its cost); `stats` receives 8 int32
// per block: count, first, trail, lead, has_nl, then with `first_line` the
// text offset of the block's lead flag (-1 if none), else 0, then 0, 0.
// `totals` (nullable) receives the rows folded in text order, 8 int32:
// count, matched lines, trail, lead, has_nl, 0, 0, 0, by the launch's last
// block; `scratch` is krep_tail_words() int32 of device memory, zero,
// that no other launch uses at the same time (scan_common.cuh
// finish_blocks). Returns the launch's cudaGetLastError().
extern "C" int krep_scan_blocks(const void* text, int nblocks, const unsigned char* pattern,
                                int m, int icase, int wword, int true_len, int prev_word,
                                int start_limit, int first_line, void* mask, void* stats,
                                void* totals, void* scratch, void* stream) {
  if (m < 1 || m > kMaxPattern || nblocks < 1 || first_line < 0 || first_line > 2)
    return int(cudaErrorInvalidValue);
  if (first_line && (!mask || (first_line == 1 && !totals))) return int(cudaErrorInvalidValue);
  if (!tail_ok(nblocks, totals, scratch)) return int(cudaErrorInvalidValue);
  Pattern p;
  memset(p.w, 0, sizeof(p.w));
  memcpy(p.w, pattern, m);  // little-endian host and device
  const int kind = first_line ? kFirstLineMask : mask ? kStartMask : kNoMask;
  const ScanKernel kernel = kScanInstances[3 * (2 * len_class(m) + (wword ? 1 : 0)) + kind];
  kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), p, m, icase, true_len, prev_word, start_limit,
      static_cast<uint8_t*>(mask), static_cast<int*>(stats), static_cast<int*>(totals),
      static_cast<int*>(scratch), first_line == 1 ? static_cast<uint8_t*>(mask) : nullptr);
  return int(cudaGetLastError());
}

// The int32 words of the scan tail's scratch (scan_common.cuh kTailWords).
extern "C" int krep_tail_words() { return kTailWords; }

// Folds nblocks block summaries in text order into 8 int32 at `out`:
// count, matched lines, trail, lead, has_nl, 0, 0, 0. For the summaries of
// kernels without the scan tail.
extern "C" int krep_combine_blocks(const void* stats, int nblocks, void* out, void* stream) {
  if (nblocks < 1) return int(cudaErrorInvalidValue);
  combine_blocks_kernel<<<1, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stats), nblocks, static_cast<int*>(out));
  return int(cudaGetLastError());
}
