// K-pattern fused scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the K>1 modes of the TPU kernel krep_tpu/ops/pallas_swar.py
// `_make_kernel` (built at :396, launched by `_scan_raw` :883, pallas_call
// at :961; public entries `scan_multi` :980, `scan_shard_multi` :1127): the
// all-starts match of up to 64 patterns of 1-64 bytes in one pass, with the
// -i fold and the -w word boundaries. Outputs the Aho-Corasick count (the
// sum over patterns of each pattern's all-starts count, multi.py:1-18), the
// matched-line count of the UNION of matches, and the 0/1 union start mask.
//
// What bounds it on the card: the per-byte candidate test. Like the K=1
// kernel (swar_scan.cu) it reads the staged text once, into shared memory,
// so bytes moved are n (and n more with a mask); the work per byte is one
// look-up in a 256-bit first-byte bitmap and, for the bytes whose first
// byte starts some pattern, a verify of that byte's bucket of patterns.
// The design keeps both in shared memory:
//   * the block geometry of the K=1 kernel: one CUDA block per 64 KiB with
//     a 64-byte tail, 256 threads x 256 contiguous bytes, padded rows;
//   * the pattern set (bytes, lengths, the bitmap and per-first-byte
//     bucket lists) is a small device buffer that the wrapper builds for
//     each call and each block copies into shared memory once. It is not
//     `__constant__`: concurrent launches with other sets share nothing.
//
// The union hit drives the mask byte and the line state; `count` adds the
// number of patterns that match at the byte. So a block's stats[0] counts
// matches, not mask bytes: the mask readback (ops/dispatch.py
// starts_from_device_mask) only tests group counts for zero, and a block
// has a match exactly when its mask has a set byte.
//
// -w tests each pattern's own after-byte at o + m_k and the byte before
// directly, as the K=1 kernel does (not the TPU kernel's SWAR borrow, which
// drops matches after "_^").
//
// The shard mode (kShard, for `scan_shard_multi` :1127, the sharded route
// of parallel/mesh.py) bounds every pattern's starts, and the newlines that
// count, to [0, start_limit): the shard's owned bytes, while matches may run
// on into the halo up to true_len. It is a template argument, so the
// unbounded scans compile as before. prev_word is the -w flag of the byte
// before the text (the previous shard's last byte), read by block 0.

#include "scan_common.cuh"

namespace {

constexpr int kMaxPatterns = 64;

// Built by ops/swar.py `_pattern_set` (the byte layout is fixed there too).
struct PatternSet {
  unsigned char bytes[kMaxPatterns][kMaxPattern];  // folded for -i
  int len[kMaxPatterns];
  uint32_t first_map[8];                           // bit c: some pattern starts with byte c
  unsigned char bucket_off[264];                   // bucket of byte c: bucket[off[c] .. off[c+1])
  unsigned char bucket[kMaxPatterns];              // pattern indices, grouped by first byte
};
static_assert(sizeof(PatternSet) == 4712, "PatternSet layout is shared with ops/swar.py");

template <bool kShard>
__global__ void __launch_bounds__(kThreads)
scan_blocks_multi_kernel(const uint8_t* __restrict__ text, const PatternSet* __restrict__ set,
                         int icase, int wword, int true_len, int prev_word, int start_limit,
                         uint8_t* __restrict__ mask, int* __restrict__ stats) {
  extern __shared__ uint32_t smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  __shared__ PatternSet ps;
  __shared__ Summary warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const int base = blockIdx.x * kBlockBytes;  // staged arrays stay below 2 GiB
  const uint8_t* block = text + size_t(base);

  // 1. The pattern set, the block's 64 KiB and the 64-byte tail into
  //    shared memory.
  {
    const int* src = reinterpret_cast<const int*>(set);
    int* dst = reinterpret_cast<int*>(&ps);
    for (int k = t; k < int(sizeof(PatternSet) / 4); k += kThreads) dst[k] = src[k];
  }
  const uint4* src = reinterpret_cast<const uint4*>(block);
#pragma unroll 4
  for (int k = 0; k < kBlockBytes / 16 / kThreads; ++k) {
    const int chunk = k * kThreads + t;
    uint4 v = src[chunk];
    if (icase) {
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
  if (t < kTail / 4) {
    uint32_t v = reinterpret_cast<const uint32_t*>(block + kBlockBytes)[t];
    if (icase) v = fold4(v);
    reinterpret_cast<uint32_t*>(smem + kThreads * kRow)[t] = v;
  }
  __syncthreads();

  // 2. Each thread walks its 256 bytes in order.
  const int off0 = t * kSpan;
  int prev_w = 0;
  if (wword) {
    if (t > 0)
      prev_w = is_word(smem[sidx(off0 - 1)]);
    else if (blockIdx.x > 0)
      prev_w = is_word(block[-1]);  // folding keeps word-ness
    else
      prev_w = prev_word;
  }
  // kShard: the bytes of this span below start_limit (<= 0: none, > kSpan: all)
  const int owned = kShard ? start_limit - base - off0 : kSpan;
  Summary s = {0, 0, 0, 0, 0};
  int state = 0;
  uint32_t mword = 0;
  for (int j = 0; j < kSpan; ++j) {
    const int o = off0 + j;
    const int g = base + o;
    const unsigned c = smem[sidx(o)];
    int n = 0;
    if ((!kShard || j < owned) && ((ps.first_map[c >> 5] >> (c & 31)) & 1u)) {
      const int e1 = ps.bucket_off[c + 1];
      for (int e = ps.bucket_off[c]; e < e1; ++e) {
        const int k = ps.bucket[e];
        const int m = ps.len[k];
        if (g > true_len - m) continue;
        int ok = 1;
        for (int i = 1; i < m; ++i) {
          if (smem[sidx(o + i)] != ps.bytes[k][i]) {
            ok = 0;
            break;
          }
        }
        if (ok && wword) ok = !prev_w && !is_word(smem[sidx(o + m)]);
        n += ok;
      }
    }
    if (wword) prev_w = is_word(c);
    walk_step(s, state, n, (c == '\n') & (!kShard || j < owned));
    if (mask) {
      mword |= uint32_t(n > 0) << (8 * (j & 3));
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

}  // namespace

// Per-block summaries of nblocks * 64 KiB of staged text for the pattern
// set at `set` (a device PatternSet). `text` must hold nblocks * 65536 + 64
// readable bytes and be 16-byte aligned; `mask` (nullable) receives one 0/1
// union byte per text byte; `stats` receives 8 int32 per block: matches,
// first, trail, lead, has_nl, 0, 0, 0. `prev_word` is the -w flag of the
// byte before the text; with `shard`, starts and the newlines that count lie
// below `start_limit`. Returns the launch's cudaGetLastError().
extern "C" int krep_scan_blocks_multi(const void* text, int nblocks, const void* set, int icase,
                                      int wword, int true_len, int prev_word, int start_limit,
                                      int shard, void* mask, void* stats, void* stream) {
  if (nblocks < 1) return int(cudaErrorInvalidValue);
  auto kernel = shard ? scan_blocks_multi_kernel<true> : scan_blocks_multi_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<nblocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const PatternSet*>(set), icase, wword,
      true_len, prev_word, start_limit, static_cast<uint8_t*>(mask), static_cast<int*>(stats));
  return int(cudaGetLastError());
}
