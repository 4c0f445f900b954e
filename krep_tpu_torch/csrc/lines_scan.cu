// Matched-line summaries from a precomputed start mask, for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel krep_tpu/ops/pallas_swar.py `_make_lines_kernel`
// (built at :1011, pallas_call at :1112 in `lines_from_mask` :1058): the
// distinct matched-line count of a union mask (multi-pattern -c on the
// Hamming route, krep_tpu/ops/multi.py:204). Only a few integers per
// 64 KiB leave the kernel; swar_scan.cu's `combine_blocks` folds them.
//
// What bounds it on the card: bytes moved, 2n (the text and the 0/1 mask).
// Each CUDA block reads its 64 KiB of both with coalesced 16-byte loads and
// keeps one code byte per position in shared memory (bit 0: '\n', bit 1:
// a match starts here), so the in-order walk of each thread's 256 bytes
// reads shared memory only. Then it emits the same Summary rows as the scan
// kernels (scan_common.cuh): the TPU kernel's carry across its sequential
// grid becomes the ordered fold of those rows.
//
// A match on a '\n' byte belongs to the line that '\n' ends (find_line_start,
// krep.c:363-386) and the state resets after it. That is the TPU kernel's
// `nl_start_matches` rule (pallas_swar.py:1024-1033), which its caller
// turns on when a pattern starts with '\n' (multi.py:206); when none does,
// no flag sits on a newline and the switch changes nothing. So the kernel
// needs no switch.

#include "scan_common.cuh"

namespace {

// 0x01 in every byte of x that is zero, 0x00 elsewhere (carry-less).
__device__ __forceinline__ uint32_t zero_bytes01(uint32_t x) {
  return (~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu) >> 7) & 0x01010101u;
}

__device__ __forceinline__ uint32_t codes(uint32_t text, uint32_t mask) {
  return zero_bytes01(text ^ 0x0A0A0A0Au) | ((zero_bytes01(mask) ^ 0x01010101u) << 1);
}

__global__ void __launch_bounds__(kThreads)
lines_blocks_kernel(const uint8_t* __restrict__ text, const uint8_t* __restrict__ mask,
                    int* __restrict__ stats) {
  extern __shared__ uint32_t smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  __shared__ Summary warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const size_t base = size_t(blockIdx.x) * kBlockBytes;
  const uint4* tsrc = reinterpret_cast<const uint4*>(text + base);
  const uint4* msrc = reinterpret_cast<const uint4*>(mask + base);
#pragma unroll 4
  for (int k = 0; k < kBlockBytes / 16 / kThreads; ++k) {
    const int chunk = k * kThreads + t;
    const uint4 x = tsrc[chunk];
    const uint4 y = msrc[chunk];
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem + sidx(chunk * 16));
    dst[0] = codes(x.x, y.x);
    dst[1] = codes(x.y, y.y);
    dst[2] = codes(x.z, y.z);
    dst[3] = codes(x.w, y.w);
  }
  __syncthreads();

  const int off0 = t * kSpan;
  Summary s = {0, 0, 0, 0, 0};
  int state = 0;
  for (int j = 0; j < kSpan; ++j) {
    const unsigned c = smem[sidx(off0 + j)];
    walk_step(s, state, int(c >> 1), int(c & 1));
  }
  s.trail = state;
  store_block_summary(s, warp_sums, stats);
}

}  // namespace

// Per-block summaries (8 int32 per block: set mask bytes, first, trail,
// lead, has_nl, 0, 0, 0) of nblocks * 64 KiB of staged text and its 0/1
// start mask; both 16-byte aligned. Returns the launch's cudaGetLastError().
extern "C" int krep_lines_blocks(const void* text, const void* mask, int nblocks, void* stats,
                                 void* stream) {
  if (nblocks < 1) return int(cudaErrorInvalidValue);
  constexpr int smem_bytes = kThreads * kRow;  // no tail: nothing reads past the block
  cudaError_t err = cudaFuncSetAttribute(
      lines_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  lines_blocks_kernel<<<nblocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const uint8_t*>(mask),
      static_cast<int*>(stats));
  return int(cudaGetLastError());
}
