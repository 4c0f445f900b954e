// Byte-per-thread literal scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel krep_tpu/ops/pallas_scan.py `_make_kernel` (built
// at :116, pallas_call at :281 in `scan_literal` :225), the v1 byte-per-lane
// scan of one pattern of 1..4096 bytes (:248-249): the all-starts match with
// the -i fold and the -w word boundaries, the match count, the matched-line
// count and the u8 start mask. It also replaces the four cost-attribution
// variants of that kernel in tools/bench_kernel.py `variant_kernel` (:23,
// pallas_call at :111 in `run_variant` :90), as template instances of the
// same kernel:
//   passthrough    the int32 sum of the body bytes (two's-complement wrap);
//   compares_only  the match count;
//   lines_only     the match count and the matched-line count;
//   full           the same as lines_only (one body in the TPU tool too).
// The variants take no -i, -w or mask, as there.
//
// What bounds it on the card: bytes moved, n read (+ n written with a mask),
// while patterns stay short. A long pattern on repetitive text is O(n * m)
// byte compares, as on the TPU, where every shifted compare runs for every
// byte; here the first-byte reject and the early exit on the first
// mismatching byte keep ordinary text near one compare per byte.
// The design:
//   * one CUDA block per 64 KiB of staged text copies its bytes and the
//     4 KiB after them (the next block's head, or the staged zero halo) into
//     shared memory, 68 KiB in rows padded to 260 bytes, folding -i there;
//     the pattern (<= 4096 bytes, folded on the host) goes beside it, 72 KiB
//     in all, above the 48 KiB default, so the launch opts in;
//   * each of the 256 threads walks 256 contiguous starts byte by byte:
//     a first-byte reject, then the pattern bytes until one differs;
//   * -w reads the byte before a start and the byte after the match directly
//     (the TPU kernel's word flags are direct byte tests too, :49-55); the
//     byte before block 0 is non-word and the byte after a match is read
//     even past true_len (zeros there on fresh staging), as at :157-161.
// The TPU kernel carries the open-line flag and the -w previous-byte flag
// across its sequential grid in SMEM (scratch[2..3], :131-134, :199-208).
// CUDA blocks run in no order, so each block writes a line-accounting
// summary instead (scan_common.cuh), which combine_blocks (swar_scan.cu)
// folds in text order, and the -w flag is a direct read.
//
// Simple first: no cp.async, TMA or word compares.

#include "scan_common.cuh"

namespace {

constexpr int kMaxBytePattern = 4096;                      // pallas_scan.py:248
constexpr int kHaloBytes = 4096;                           // the staged zero halo
constexpr int kHaloRows = kHaloBytes / kSpan;              // 16 rows of shared memory
constexpr int kTextSmem = (kThreads + kHaloRows) * kRow;   // 70,720 bytes
constexpr int kByteSmem = kTextSmem + kMaxBytePattern;     // + the pattern

enum Variant { kScan = 0, kPassthrough = 1, kComparesOnly = 2, kLinesOnly = 3, kFull = 4 };

// The block's row of 8 int32 stats with only word 0 set (passthrough).
__device__ __forceinline__ void store_block_word0(uint32_t v, uint32_t* warp_words, int* stats) {
  const int t = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((t & 31) == 0) warp_words[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    uint32_t s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_words[w];
    int* out = stats + blockIdx.x * kStatWords;
    out[0] = int(s);
    out[1] = out[2] = out[3] = out[4] = out[5] = out[6] = out[7] = 0;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
byte_scan_kernel(const uint8_t* __restrict__ text, const uint8_t* __restrict__ pattern, int m,
                 int icase, int wword, int true_len, uint8_t* __restrict__ mask,
                 int* __restrict__ stats) {
  extern __shared__ uint32_t smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  uint8_t* pat = smem + kTextSmem;
  __shared__ Summary warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const int base = blockIdx.x * kBlockBytes;  // staged arrays stay below 2 GiB
  const uint8_t* block = text + size_t(base);
  const uint4* src = reinterpret_cast<const uint4*>(block);

  if constexpr (V == kPassthrough) {
    // the body bytes, summed (each block's sum stays below 2^24)
    uint32_t s = 0;
#pragma unroll 4
    for (int k = 0; k < kBlockBytes / 16 / kThreads; ++k) {
      const uint4 v = src[k * kThreads + t];
      s += __vsadu4(v.x, 0) + __vsadu4(v.y, 0) + __vsadu4(v.z, 0) + __vsadu4(v.w, 0);
    }
    store_block_word0(s, reinterpret_cast<uint32_t*>(warp_sums), stats);
    return;
  }

  // 1. The block's 64 KiB and the 4 KiB after it into shared memory, and
  //    the pattern beside them.
  const bool fold = V == kScan && icase;
#pragma unroll 4
  for (int k = 0; k < (kBlockBytes + kHaloBytes) / 16 / kThreads; ++k) {
    const int chunk = k * kThreads + t;
    uint4 v = src[chunk];
    if (fold) {
      v.x = fold4(v.x);
      v.y = fold4(v.y);
      v.z = fold4(v.z);
      v.w = fold4(v.w);
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem + sidx(chunk * 16));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  for (int i = t; i < m; i += kThreads) pat[i] = pattern[i];
  __syncthreads();

  // 2. Each thread walks its 256 starts in order.
  const bool ww = V == kScan && wword;
  const int off0 = t * kSpan;
  int prev_w = 0;
  if (ww) {
    if (t > 0)
      prev_w = is_word(smem[sidx(off0 - 1)]);
    else if (blockIdx.x > 0)
      prev_w = is_word(block[-1]);  // folding keeps word-ness
  }
  const int last_start = true_len - m;  // inclusive bound on starts
  const unsigned p0 = pat[0];
  Summary s = {0, 0, 0, 0, 0};
  int state = 0;  // the open line already has a match
  uint32_t mword = 0;
  for (int j = 0; j < kSpan; ++j) {
    const int o = off0 + j;
    const int g = base + o;
    const unsigned c = smem[sidx(o)];
    int hit = 0;
    if (c == p0 && g <= last_start) {
      hit = 1;
      for (int k = 1; k < m; ++k) {
        if (smem[sidx(o + k)] != pat[k]) {
          hit = 0;
          break;
        }
      }
      if (hit && ww) hit = !prev_w && !is_word(smem[sidx(o + m)]);
    }
    if (ww) prev_w = is_word(c);
    if constexpr (V == kComparesOnly)
      s.count += hit;
    else
      walk_step(s, state, hit, c == '\n');
    if (V == kScan && mask) {
      mword |= uint32_t(hit) << (8 * (j & 3));
      if ((j & 3) == 3) {
        *reinterpret_cast<uint32_t*>(mask + g - 3) = mword;
        mword = 0;
      }
    }
  }
  s.trail = state;

  // 3. Fold the 256 thread summaries in order.
  store_block_summary(s, warp_sums, stats);
}

template <int V>
int launch(const void* text, int nblocks, const void* pattern, int m, int icase, int wword,
           int true_len, void* mask, void* stats, void* stream) {
  const int smem = V == kPassthrough ? 0 : kByteSmem;
  if (smem) {
    cudaError_t err = cudaFuncSetAttribute(byte_scan_kernel<V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  byte_scan_kernel<V><<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const uint8_t*>(pattern), m, icase, wword,
      true_len, static_cast<uint8_t*>(mask), static_cast<int*>(stats));
  return int(cudaGetLastError());
}

}  // namespace

// Per-block summaries (8 int32 per block: count, first, trail, lead, has_nl,
// 0, 0, 0) of nblocks * 64 KiB of staged text, which must be 16-byte aligned
// and hold 4096 more readable bytes (the staged halo). `pattern` is a device
// buffer of m (1..4096) bytes, already folded for -i. `variant`: 0 the scan,
// with `mask` (nullable) receiving one 0/1 byte per text byte at every match
// start; 1..4 the cost-attribution variants passthrough (word 0 is the
// block's byte sum, `pattern` may be null), compares_only (word 0 only),
// lines_only and full, which take no -i, -w or mask. Returns the launch's
// cudaGetLastError().
extern "C" int krep_byte_scan(const void* text, int nblocks, const void* pattern, int m,
                              int icase, int wword, int true_len, int variant, void* mask,
                              void* stats, void* stream) {
  if (nblocks < 1 || variant < kScan || variant > kFull) return int(cudaErrorInvalidValue);
  if (variant != kPassthrough && (!pattern || m < 1 || m > kMaxBytePattern))
    return int(cudaErrorInvalidValue);
  if (variant != kScan && (icase || wword || mask)) return int(cudaErrorInvalidValue);
  switch (variant) {
    case kScan:
      return launch<kScan>(text, nblocks, pattern, m, icase, wword, true_len, mask, stats, stream);
    case kPassthrough:
      return launch<kPassthrough>(text, nblocks, pattern, 0, 0, 0, true_len, nullptr, stats,
                                  stream);
    case kComparesOnly:
      return launch<kComparesOnly>(text, nblocks, pattern, m, 0, 0, true_len, nullptr, stats,
                                   stream);
    case kLinesOnly:
      return launch<kLinesOnly>(text, nblocks, pattern, m, 0, 0, true_len, nullptr, stats,
                                stream);
    default:
      return launch<kFull>(text, nblocks, pattern, m, 0, 0, true_len, nullptr, stats, stream);
  }
}
