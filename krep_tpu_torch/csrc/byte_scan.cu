// Literal scan of one 1-4096 byte pattern for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel krep_tpu/ops/pallas_scan.py `_make_kernel` (built
// at :116, pallas_call at :281 in `scan_literal` :225), the v1 byte-per-lane
// scan of one pattern of 1..4096 bytes (:248-249): the all-starts match with
// the -i fold and the -w word boundaries, the match count, the matched-line
// count and the u8 start mask. It also replaces the four cost-attribution
// variants of that kernel in tools/bench_kernel.py `variant_kernel` (:23,
// pallas_call at :111 in `run_variant` :90), as cut-down instances of the
// same body:
//   passthrough    the int32 sum of the body bytes (two's-complement wrap):
//                  the read alone;
//   compares_only  the match count: the filter, the verify and a popc;
//   lines_only     the match count and the matched-line count: the same plus
//                  the bit-word line fold;
//   full           the same as lines_only (one body in the TPU tool too).
// The variants take no -i, -w or mask, as there.
//
// What bounds it on the card: bytes moved, n read (+ n written with a
// mask), once the work per byte is a few instructions; a long pattern on
// repetitive text is O(n * m) byte compares, as on the TPU. The first
// design copied each block into shared memory and walked every thread's
// 256 bytes one at a time, with a compare loop and an early exit at every
// byte equal to the pattern's first and the -i, -w and mask tests at run
// time, and wrote the mask 4 bytes at a time with a warp's lanes 256 bytes
// apart: 3.1 ms per GiB, 6.4-6.6 with the mask. This design is the word
// scan of scan_common.cuh (word_scan_block), the same core as the K=1 scan
// of swar_scan.cu (its note has the layout): lanes hold 16 bytes each in
// registers, straight from global memory; each start position is a masked
// window compare of the first 4 or 8 pattern bytes, exact up to 8; past 8
// those 8 bytes filter, and a warp verifies its candidates 32 at a time
// against the pattern, which a block keeps in shared memory (at most 4 KiB),
// reading text words from global memory (the staged 4 KiB halo covers the
// longest pattern's tail); lines and the mask come from bit words; the
// length class, -w and the mask are template arguments (12 scan instances,
// 3 compares_only instances; lines_only and full run the scan instance
// without -w and mask). -w reads the byte before a start and the byte after
// the match directly (the TPU kernel's word flags are direct byte tests
// too, :49-55); the byte before block 0 is non-word and the byte after a
// match is read even past true_len (zeros there on fresh staging), as at
// :157-161. The TPU kernel carries the open-line flag and the -w
// previous-byte flag across its sequential grid in SMEM (scratch[2..3],
// :131-134, :199-208); here each block writes a line-accounting summary,
// and the scan instances fold them in text order in the launch's last
// block (scan_common.cuh finish_blocks), writing the totals beside the
// rows. The variants write rows only; the tool folds them with
// swar_scan.cu's combine_blocks.

#include "scan_common.cuh"

namespace {

constexpr int kMaxBytePattern = 4096;                 // pallas_scan.py:248
constexpr int kBytePatWords = kMaxBytePattern / 4 + 2;
constexpr int kNoLimit = 0x7FFFFFF0;                  // no start_limit: every newline counts

enum Variant { kScan = 0, kPassthrough = 1, kComparesOnly = 2, kLinesOnly = 3, kFull = 4 };

template <int kLen, bool kWord, int kMask, bool kLines>
__global__ void __launch_bounds__(kThreads)
byte_scan_kernel(const uint8_t* __restrict__ text, const uint8_t* __restrict__ pattern, int m,
                 int icase, int true_len, uint8_t* __restrict__ mask, int* __restrict__ stats,
                 int* __restrict__ totals, int* scratch) {
  __shared__ WordScanShared<kBytePatWords> sh;
  // the pattern's words (the filter's two for a short one), zero past m
  const int nw = kLen == kLenLong ? (m + 3) / 4 : 2;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i)
      if (4 * w + i < m) v |= uint32_t(pattern[4 * w + i]) << (8 * i);
    sh.pat[w] = v;
  }
  __syncthreads();
  word_scan_block<kLen, kWord, kMask, kLines>(
      WordScanArgs{text, m, icase, true_len, 0, kNoLimit, mask, stats}, sh);
  finish_blocks(stats, totals, scratch, sh.warp_sums);
}

// passthrough: the body bytes, summed (each block's sum stays below 2^24),
// into word 0 of the block's row of 8 int32 stats.
__global__ void __launch_bounds__(kThreads)
passthrough_kernel(const uint8_t* __restrict__ text, int* __restrict__ stats) {
  __shared__ uint32_t warp_words[kScanWarps];
  const int t = threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(text + size_t(blockIdx.x) * kBlockBytes);
  uint32_t s = 0;
#pragma unroll 4
  for (int k = 0; k < kBlockBytes / 16 / kThreads; ++k) {
    const uint4 v = src[k * kThreads + t];
    s += __vsadu4(v.x, 0) + __vsadu4(v.y, 0) + __vsadu4(v.z, 0) + __vsadu4(v.w, 0);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
  if ((t & 31) == 0) warp_words[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    uint32_t b = 0;
    for (int w = 0; w < kScanWarps; ++w) b += warp_words[w];
    int* out = stats + blockIdx.x * kStatWords;
    out[0] = int(b);
    out[1] = out[2] = out[3] = out[4] = out[5] = out[6] = out[7] = 0;
  }
}

using ByteKernel = void (*)(const uint8_t*, const uint8_t*, int, int, int, uint8_t*, int*, int*,
                           int*);

#define KREP_BYTE(L, W) \
  byte_scan_kernel<L, W, kNoMask, true>, byte_scan_kernel<L, W, kStartMask, true>
// the scan: (length class, -w, mask) -> instance 2 * (2 * class + word) + mask
const ByteKernel kScanInstances[12] = {
    KREP_BYTE(kLen4, false),  KREP_BYTE(kLen4, true),    KREP_BYTE(kLen8, false),
    KREP_BYTE(kLen8, true),   KREP_BYTE(kLenLong, false), KREP_BYTE(kLenLong, true),
};
#undef KREP_BYTE
// compares_only, by length class
const ByteKernel kCountInstances[3] = {
    byte_scan_kernel<kLen4, false, kNoMask, false>,
    byte_scan_kernel<kLen8, false, kNoMask, false>,
    byte_scan_kernel<kLenLong, false, kNoMask, false>,
};

}  // namespace

// Per-block summaries (8 int32 per block: count, first, trail, lead, has_nl,
// 0, 0, 0) of nblocks * 64 KiB of staged text, which must be 16-byte aligned
// and hold 4096 more readable bytes (the staged halo). `pattern` is a device
// buffer of m (1..4096) bytes, already folded for -i. `variant`: 0 the scan,
// with `mask` (nullable, 16-byte aligned) receiving one 0/1 byte per text
// byte at every match start, and `totals` (nullable) the rows folded in
// text order by the launch's last block (count, matched lines, trail, lead,
// has_nl, 0, 0, 0; `scratch` as for krep_scan_blocks); 1..4 the
// cost-attribution variants passthrough (word 0 is the block's byte sum,
// `pattern` may be null), compares_only (word 0 only), lines_only and full,
// which take no -i, -w, mask or totals. Returns the launch's
// cudaGetLastError().
extern "C" int krep_byte_scan(const void* text, int nblocks, const void* pattern, int m,
                              int icase, int wword, int true_len, int variant, void* mask,
                              void* stats, void* totals, void* scratch, void* stream) {
  if (nblocks < 1 || variant < kScan || variant > kFull) return int(cudaErrorInvalidValue);
  if (variant != kPassthrough && (!pattern || m < 1 || m > kMaxBytePattern))
    return int(cudaErrorInvalidValue);
  if (variant != kScan && (icase || wword || mask || totals)) return int(cudaErrorInvalidValue);
  if (!tail_ok(nblocks, totals, scratch)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* tx = static_cast<const uint8_t*>(text);
  int* st = static_cast<int*>(stats);
  if (variant == kPassthrough) {
    passthrough_kernel<<<nblocks, kThreads, 0, s>>>(tx, st);
    return int(cudaGetLastError());
  }
  const int cls = len_class(m);
  const ByteKernel kernel =
      variant == kComparesOnly ? kCountInstances[cls]
                               : kScanInstances[2 * (2 * cls + (wword ? 1 : 0)) + (mask ? 1 : 0)];
  kernel<<<nblocks, kThreads, 0, s>>>(tx, static_cast<const uint8_t*>(pattern), m, icase,
                                      true_len, static_cast<uint8_t*>(mask), st,
                                      static_cast<int*>(totals), static_cast<int*>(scratch));
  return int(cudaGetLastError());
}
