// Single-literal scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the K=1 modes of the TPU kernel krep_tpu/ops/pallas_swar.py
// `_make_kernel` (built at :396, launched by `_scan_raw` :883, pallas_call
// at :961): the all-starts match of one 1-64 byte pattern with the -i fold
// and the -w word boundaries, the match count, the matched-line count
// (the -c dedup: a line counts once, at its first match), the 0/1 start
// mask, and the shard statistics of `scan_shard` (first-in-line count,
// trail, lead, has_nl) bounded by `start_limit` and `prev_word`.
//
// What bounds it on the card: bytes moved. One pass reads the staged text
// (n bytes) and, with a mask, writes n mask bytes; everything else is a few
// integers per 64 KiB. The design keeps that to one read of the text:
//   * one CUDA block per 64 KiB of staged text copies its bytes (plus a
//     64-byte tail for matches that cross into the next block or the zero
//     halo) into shared memory with coalesced 16-byte loads, folding -i
//     there once;
//   * each of the 256 threads then walks 256 contiguous bytes of that
//     copy. Rows are padded to 260 bytes so the 32 threads of a warp read
//     32 different banks;
//   * the pattern travels by value in the kernel's argument struct, so
//     concurrent launches with different patterns never share state.
//
// The TPU kernel carries the open-line flag, the -w previous-byte flag and
// the shard stats from one grid step to the next in scratch memory. CUDA
// blocks run in no order, so nothing is carried: the -w flag is a direct
// read of the previous byte, and each block (and each thread inside it)
// emits a summary that a second, one-block kernel folds in text order with
// the algebra of LineCountCombiner.push (krep_tpu/parallel/mesh.py:135-143).
// The folded summary is the matched-line count and, unchanged, the shard
// stats of the slab loop, so -c, plain scans and slabs share one path.
//
// Simple first: no cp.async or TMA, and the SWAR word tricks of the TPU
// kernel are not used.

#include <string.h>

#include "scan_common.cuh"

namespace {

constexpr int kCombineThreads = 1024;

struct Pattern {
  unsigned char b[kMaxPattern];
};

__global__ void __launch_bounds__(kThreads)
scan_blocks_kernel(const uint8_t* __restrict__ text, Pattern pat, int m, int icase,
                   int wword, int true_len, int prev_word, int start_limit,
                   uint8_t* __restrict__ mask, int* __restrict__ stats) {
  extern __shared__ uint32_t smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  __shared__ Summary warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const int base = blockIdx.x * kBlockBytes;  // staged arrays stay below 2 GiB
  const uint8_t* block = text + size_t(base);

  // 1. The block's 64 KiB and the 64-byte tail into shared memory.
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
  const int last_start = min(true_len - m, start_limit - 1);  // inclusive bound on starts
  const unsigned char p0 = pat.b[0];
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
        if (smem[sidx(o + k)] != pat.b[k]) {
          hit = 0;
          break;
        }
      }
      if (hit && wword) hit = !prev_w && !is_word(smem[sidx(o + m)]);
    }
    if (wword) prev_w = is_word(c);
    const int nl = (c == '\n') & (g < start_limit);
    if (hit) {
      ++s.count;
      s.first += !state;
      s.lead |= !s.has_nl;
    }
    state = nl ? 0 : (state | hit);
    s.has_nl |= nl;
    if (mask) {
      mword |= uint32_t(hit) << (8 * (j & 3));
      if ((j & 3) == 3) {
        *reinterpret_cast<uint32_t*>(mask + g - 3) = mword;
        mword = 0;
      }
    }
  }
  s.trail = state;

  // 3. Fold the 256 thread summaries in order.
  s = warp_fold(s);
  if ((t & 31) == 0) warp_sums[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    Summary b = warp_sums[0];
    for (int w = 1; w < kThreads / 32; ++w) b = combine(b, warp_sums[w]);
    int* out = stats + blockIdx.x * kStatWords;
    out[0] = b.count;
    out[1] = b.first;
    out[2] = b.trail;
    out[3] = b.lead;
    out[4] = b.has_nl;
    out[5] = out[6] = out[7] = 0;
  }
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

}  // namespace

// Per-block summaries of nblocks * 64 KiB of staged text. `text` must hold
// nblocks * 65536 + 64 readable bytes (the staged 4 KiB zero halo covers the
// tail) and be 16-byte aligned; `pattern` holds m bytes, already folded for
// -i; `mask` (nullable) receives one 0/1 byte per text byte; `stats`
// receives 8 int32 per block: count, first, trail, lead, has_nl, 0, 0, 0.
// Returns the launch's cudaGetLastError().
extern "C" int krep_scan_blocks(const void* text, int nblocks, const unsigned char* pattern,
                                int m, int icase, int wword, int true_len, int prev_word,
                                int start_limit, void* mask, void* stats, void* stream) {
  if (m < 1 || m > kMaxPattern || nblocks < 1) return int(cudaErrorInvalidValue);
  Pattern p;
  memset(p.b, 0, sizeof(p.b));
  memcpy(p.b, pattern, m);
  cudaError_t err = cudaFuncSetAttribute(
      scan_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return int(err);
  scan_blocks_kernel<<<nblocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), p, m, icase, wword, true_len, prev_word, start_limit,
      static_cast<uint8_t*>(mask), static_cast<int*>(stats));
  return int(cudaGetLastError());
}

// Folds nblocks block summaries in text order into 8 int32 at `out`:
// count, matched lines, trail, lead, has_nl, 0, 0, 0.
extern "C" int krep_combine_blocks(const void* stats, int nblocks, void* out, void* stream) {
  if (nblocks < 1) return int(cudaErrorInvalidValue);
  combine_blocks_kernel<<<1, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stats), nblocks, static_cast<int*>(out));
  return int(cudaGetLastError());
}
