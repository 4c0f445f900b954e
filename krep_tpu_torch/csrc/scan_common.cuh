// Pieces shared by the port's scan kernels (swar_scan.cu, multi_scan.cu,
// lines_scan.cu, hamming_scan.cu, byte_scan.cu): the 64 KiB block geometry, the
// line-accounting summary and its ordered fold (byte by byte, or 32
// positions at a time from bit words), the ASCII fold, the word-byte test,
// and the coalesced store of a start bitmap as a 0/1 byte mask.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockBytes = 65536;                // staged bytes per CUDA block
constexpr int kThreads = 256;
constexpr int kSpan = kBlockBytes / kThreads;     // contiguous bytes per thread
constexpr int kRow = kSpan + 4;                   // padded shared-memory row
constexpr int kTail = 64;                         // m-1 <= 63 match bytes + the -w after-byte
constexpr int kSmemBytes = (kThreads + 1) * kRow; // 256 rows + the tail row
constexpr int kMaxPattern = 64;
constexpr int kStatWords = 8;

// Line-accounting summary of a run of bytes, entered with a closed line.
//   count   matches;
//   first   matches that are the first of their line;
//   trail   the line open at the end has a match (a match after the last
//           newline; any match at all when there is no newline);
//   lead    a match before the first newline, or on it (a match that starts
//           on a '\n' belongs to the line that '\n' ends); any match at all
//           when there is no newline;
//   has_nl  the run holds a newline below start_limit.
struct Summary {
  int count, first, trail, lead, has_nl;
};

__device__ __forceinline__ Summary combine(const Summary& x, const Summary& y) {
  Summary r;
  r.count = int(unsigned(x.count) + unsigned(y.count));  // wraps (the byte sum of passthrough)
  r.first = x.first + y.first - (x.trail & y.lead);  // the spanning line counted once
  r.trail = y.has_nl ? y.trail : (x.trail | y.trail);
  r.lead = x.has_nl ? x.lead : (x.lead | y.lead);
  r.has_nl = x.has_nl | y.has_nl;
  return r;
}

__device__ __forceinline__ Summary shfl_down(const Summary& s, int off) {
  Summary r;
  r.count = __shfl_down_sync(0xffffffffu, s.count, off);
  r.first = __shfl_down_sync(0xffffffffu, s.first, off);
  r.trail = __shfl_down_sync(0xffffffffu, s.trail, off);
  r.lead = __shfl_down_sync(0xffffffffu, s.lead, off);
  r.has_nl = __shfl_down_sync(0xffffffffu, s.has_nl, off);
  return r;
}

// Ordered tree over a warp: lane 0 ends with lanes 0..31 folded in order.
__device__ __forceinline__ Summary warp_fold(Summary s) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const Summary o = shfl_down(s, off);
    if ((lane & (2 * off - 1)) == 0) s = combine(s, o);
  }
  return s;
}

// ASCII lower-fold of 4 bytes at once (lower_table, krep.c:124-134).
// Carry-less: every add stays inside its byte's low 7 bits.
__device__ __forceinline__ uint32_t fold4(uint32_t x) {
  const uint32_t hb = x & 0x80808080u;
  const uint32_t a = x & 0x7F7F7F7Fu;
  const uint32_t ge_a = (a + 0x3F3F3F3Fu) & 0x80808080u;  // byte >= 'A'
  const uint32_t gt_z = (a + 0x25252525u) & 0x80808080u;  // byte >  'Z'
  const uint32_t upper = ge_a & ~gt_z & ~hb;
  return x + (upper >> 2);                                // +0x20 per upper byte
}

// is_word_char (krep.h:298-305): [0-9A-Za-z_].
__device__ __forceinline__ int is_word(unsigned c) {
  return (c - '0' < 10u) | ((c | 0x20u) - 'a' < 26u) | (c == '_');
}

// Shared-memory address of block-local byte offset o (o < kBlockBytes + kTail).
__device__ __forceinline__ int sidx(int o) { return (o >> 8) * kRow + (o & (kSpan - 1)); }

// One byte of a thread's in-order walk: `hit` matches start here (the
// union decides the line state; `n` is what `count` adds), `nl` says the
// byte is a newline. `state`: the open line already has a match.
__device__ __forceinline__ void walk_step(Summary& s, int& state, int n, int nl) {
  const int hit = n > 0;
  s.count += n;
  if (hit) {
    s.first += !state;
    s.lead |= !s.has_nl;
  }
  state = nl ? 0 : (state | hit);
  s.has_nl |= nl;
}

// Newline flags of the 4 bytes of a little-endian text word, as bits 0..3.
__device__ __forceinline__ uint32_t newline_bits4(uint32_t w) {
  const uint32_t e = __vcmpeq4(w, 0x0A0A0A0Au) & 0x01010101u;
  return (e * 0x01020408u) >> 24;  // byte i's flag to bit 24 + i; no carries
}

// walk_step over 32 positions at once, from bit words (bit j: position j):
// `hits` the union starts, `nl` the newlines that count. `state` is the
// open line's flag before and after them; `count` is left to the caller.
// The flag entering position j is the carry into bit j of gen + prop +
// state, where a hit off a newline generates it and every non-newline
// propagates it (a newline clears it, also when a match starts on it).
__device__ __forceinline__ void fold_bits(Summary& s, uint32_t& state, uint32_t hits, uint32_t nl) {
  const uint32_t gen = hits & ~nl, prop = ~nl;
  const uint64_t sum = uint64_t(gen) + prop + state;
  const uint32_t open = uint32_t(sum) ^ gen ^ prop;  // bit j: the line open at j has a match
  s.first += __popc(hits & ~open);
  const uint32_t upto = nl ? nl ^ (nl - 1) : ~0u;    // positions through the first newline
  s.lead |= !s.has_nl && (hits & upto) != 0;
  s.has_nl |= nl != 0;
  state = uint32_t(sum >> 32);
}

// The 0/1 bytes of a nibble's 4 bits (the four shifted copies do not overlap).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Writes a block's start bitmap `bits` (bit o%32 of word o/32: a start at
// block offset o, in shared memory) as its kBlockBytes 0/1 mask bytes at
// `out`: 16-byte stores, consecutive threads at consecutive addresses, so a
// warp stores 512 contiguous bytes at once. Every thread of the block calls
// it, after the bitmap is complete.
__device__ __forceinline__ void store_mask_bits(const uint32_t* bits, uint8_t* out) {
#pragma unroll 4
  for (int i = 0; i < kBlockBytes / 16 / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;  // 16-byte chunk
    const uint32_t b = bits[c >> 1] >> (16 * (c & 1));
    reinterpret_cast<uint4*>(out)[c] =
        make_uint4(spread4(b & 15), spread4((b >> 4) & 15), spread4((b >> 8) & 15),
                   spread4((b >> 12) & 15));
  }
}

// Folds the block's thread summaries in thread order (the threads walk
// consecutive spans) and writes the block's row of 8 int32 stats.
__device__ __forceinline__ void store_block_summary(Summary s, Summary* warp_sums, int* stats) {
  const int t = threadIdx.x;
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

}  // namespace
