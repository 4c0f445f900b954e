// Matched-line summaries from a precomputed start mask, for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel krep_tpu/ops/pallas_swar.py `_make_lines_kernel`
// (built at :1011, pallas_call at :1112 in `lines_from_mask` :1058): the
// distinct matched-line count of a union mask (multi-pattern -c on the
// Hamming route, krep_tpu/ops/multi.py:204). Only a few integers per
// 64 KiB leave the kernel, and the launch's last block folds them into the
// totals (scan_common.cuh finish_blocks, whose note has the counter's
// argument): the TPU kernel's carry across its sequential grid becomes the
// ordered fold of the block rows.
//
// What bounds it on the card: bytes moved, 2n (the text and the 0/1 mask:
// 0.64 ms per GiB of text at 3.35 TB/s); it compares nothing. The first
// design copied each block's 64 KiB of text and of mask into shared-memory
// code bytes and walked every thread's 256 bytes one at a time: 1.29 ms
// per GiB on an H100, half its bound. This design is the word scan's
// layout (scan_common.cuh word_scan_block) with the hit word read from the
// mask instead of compared: each warp walks 8 KiB in strides of 512 bytes,
// lane l holding text bytes 16l..16l+15 and the same 16 mask bytes as two
// uint4 loaded straight from global memory two strides ahead (coalesced;
// no shared-memory copy, no barrier in the loop); the non-zero mask bytes
// become the lane's 16-bit hit word, its newlines another (newline_bits16),
// and fold_lines16, the word scan's own line fold, gives the line state,
// first-in-line flags, lead and trail from two ballots per stride; count
// is the popc of the hits (set mask bytes).
//
// A match on a '\n' byte belongs to the line that '\n' ends (find_line_start,
// krep.c:363-386) and the state resets after it. That is the TPU kernel's
// `nl_start_matches` rule (pallas_swar.py:1024-1033), which its caller
// turns on when a pattern starts with '\n' (multi.py:206); when none does,
// no flag sits on a newline and the switch changes nothing. The carry of
// fold_lines16 keeps the rule with no switch: a hit on a newline generates
// no carry (gen = hits & ~nl), and the lead test runs through the first
// newline.

#include "scan_common.cuh"

namespace {

// Flags of the non-zero bytes of a little-endian word, as bits 0..3.
__device__ __forceinline__ uint32_t nonzero_bits4(uint32_t w) {
  const uint32_t e = __vcmpne4(w, 0u) & 0x01010101u;
  return (e * 0x01020408u) >> 24;  // byte i's flag to bit 24 + i; no carries
}

// The start flags of a lane's 16 mask bytes, as bits 0..15.
__device__ __forceinline__ uint32_t nonzero_bits16(uint4 v) {
  return nonzero_bits4(v.x) | nonzero_bits4(v.y) << 4 | nonzero_bits4(v.z) << 8 |
         nonzero_bits4(v.w) << 12;
}

__global__ void __launch_bounds__(kThreads)
lines_blocks_kernel(const uint8_t* __restrict__ text, const uint8_t* __restrict__ mask,
                    int* __restrict__ stats, int* __restrict__ totals, int* scratch) {
  __shared__ Summary warp_sums[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_off = warp * kWarpBytes;
  const size_t off = size_t(blockIdx.x) * kBlockBytes + warp_off;
  const uint4* tsrc = reinterpret_cast<const uint4*>(text + off) + lane;
  const uint4* msrc = reinterpret_cast<const uint4*>(mask + off) + lane;
  uint4 tcur = tsrc[0], tnxt = tsrc[32], mcur = msrc[0], mnxt = msrc[32];
  WarpLines lines;
#pragma unroll 1
  for (int k = 0; k < kStrides; ++k) {
    uint4 tahead = make_uint4(0, 0, 0, 0), mahead = tahead;  // nothing past the warp's span
    if (k + 2 < kStrides) {
      tahead = tsrc[32 * (k + 2)];
      mahead = msrc[32 * (k + 2)];
    }
    const uint32_t hits = nonzero_bits16(mcur);
    lines.s.count += __popc(hits);
    fold_lines16<false>(lines, hits, newline_bits16(tcur), warp_off + k * kStride);
    tcur = tnxt;
    tnxt = tahead;
    mcur = mnxt;
    mnxt = mahead;
  }
  lines.s.trail = lines.state;
  put_warp_summary(lines.s, warp_sums);
  __syncthreads();
  if (threadIdx.x == 0) write_row(stats + blockIdx.x * kStatWords, fold_warps(warp_sums), 0);
  finish_blocks(stats, totals, scratch, warp_sums);
}

}  // namespace

// Per-block summaries (8 int32 per block: set mask bytes, first, trail,
// lead, has_nl, 0, 0, 0) of nblocks * 64 KiB of staged text and its 0/1
// start mask, both 16-byte aligned, and (`totals`, nullable) their fold in
// text order by the launch's last block: set mask bytes, matched lines,
// trail, lead, has_nl, 0, 0, 0 (`scratch` as for krep_scan_blocks).
// Returns the launch's cudaGetLastError().
extern "C" int krep_lines_blocks(const void* text, const void* mask, int nblocks, void* stats,
                                 void* totals, void* scratch, void* stream) {
  if (nblocks < 1 || !tail_ok(nblocks, totals, scratch)) return int(cudaErrorInvalidValue);
  lines_blocks_kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const uint8_t*>(mask),
      static_cast<int*>(stats), static_cast<int*>(totals), static_cast<int*>(scratch));
  return int(cudaGetLastError());
}
