// Pieces shared by the port's scan kernels (swar_scan.cu, multi_scan.cu,
// lines_scan.cu, hamming_scan.cu, byte_scan.cu): the 64 KiB block geometry, the
// line-accounting summary and its ordered fold (byte by byte, or 32
// positions at a time from bit words), the ASCII fold, the word-byte test,
// the coalesced store of a start bitmap as a 0/1 byte mask, and the word
// scan of one pattern that swar_scan.cu and byte_scan.cu both run
// (word_scan_block, at the end).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockBytes = 65536;                // staged bytes per CUDA block
constexpr int kThreads = 256;
constexpr int kSpan = kBlockBytes / kThreads;     // contiguous bytes per thread
constexpr int kRow = kSpan + 4;                   // padded shared-memory row
constexpr int kTail = 64;                         // m-1 <= 63 match bytes + the -w after-byte
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


// ---------------------------------------------------------------------------
// The word scan of one pattern: swar_scan.cu's K=1 scan (with its first-line
// and shard modes) and byte_scan.cu's byte scan (and its variants) are
// instances of word_scan_block.
//
// A block's 64 KiB belongs to its 8 warps, 8 KiB each, walked 512 bytes (a
// stride) at a time. Lane l holds bytes 16l..16l+15 of the stride as one
// uint4 loaded straight from global memory (a warp's loads are 512
// contiguous bytes; no shared-memory staging), with the loads of the next
// two strides in flight. The words after a lane's 16 bytes (a window's tail and the -w
// after-byte) come from the next lane by shuffle, lane 31 taking lane 0's
// next-stride words; the -w before-byte's flag comes from the previous lane
// by shuffle, lane 0 taking lane 31's of the previous stride. A lane's 16
// start positions become a 16-bit hit word and its newlines another; both
// fold into the warp's line summary with two ballots per stride, and the
// warps' summaries fold in order at the block's end.

constexpr int kStride = 512;                          // bytes a warp takes per step
constexpr int kScanWarps = kThreads / 32;
constexpr int kWarpBytes = kBlockBytes / kScanWarps;  // 8 KiB per warp
constexpr int kStrides = kWarpBytes / kStride;        // 16 steps per warp
constexpr unsigned kAll = 0xffffffffu;

// Pattern-length classes. Up to 4 bytes one masked word compare per start
// position is exact, up to 8 two; a longer pattern takes the 8-byte compare
// as a filter and verifies the rest of each candidate (verify_long).
enum LenClass { kLen4 = 0, kLen8 = 1, kLenLong = 2 };
// What a scan writes beside its stats: no mask, every match start, or the
// -c dedup flags (the first match of each line as if the block began on a
// closed line; krep_first_line_fixup finishes them across blocks).
enum MaskKind { kNoMask = 0, kStartMask = 1, kFirstLineMask = 2 };

__host__ __device__ constexpr int len_class(int m) {
  return m <= 4 ? kLen4 : m <= 8 ? kLen8 : kLenLong;
}

// The word flags (is_word) of the 4 bytes of a little-endian text word, as
// bits 0..3. Carry-less: every add stays inside its byte's low 7 bits; a
// byte >= 0x80 is no word byte.
__device__ __forceinline__ uint32_t word_bits4(uint32_t x) {
  const uint32_t a = x & 0x7F7F7F7Fu;
  const uint32_t digit = (a + 0x50505050u) & ~(a + 0x46464646u);  // 0x30 <= a < 0x3A
  const uint32_t l = a | 0x20202020u;                                // letters to lower case
  const uint32_t alpha = (l + 0x1F1F1F1Fu) & ~(l + 0x05050505u);  // 0x61 <= l < 0x7B
  const uint32_t under = ~((a ^ 0x5F5F5F5Fu) + 0x7F7F7F7Fu);        // a == '_'
  const uint32_t f = (digit | alpha | under) & ~x & 0x80808080u;
  return ((f >> 7) * 0x01020408u) >> 24;  // byte i's flag to bit 24 + i; no carries
}

// The word flags of a lane's 16 bytes, as bits 0..15.
__device__ __forceinline__ uint32_t word_bits16(uint4 v) {
  return word_bits4(v.x) | word_bits4(v.y) << 4 | word_bits4(v.z) << 8 | word_bits4(v.w) << 12;
}

__device__ __forceinline__ uint4 fold16(uint4 v) {
  return make_uint4(fold4(v.x), fold4(v.y), fold4(v.z), fold4(v.w));
}

// Bits 0..r-1 of a 16-bit word, r clamped to 0..16.
__device__ __forceinline__ uint32_t low_bits16(int r) {
  return r >= 16 ? 0xFFFFu : r <= 0 ? 0u : (1u << r) - 1;
}

// The 16 0/1 mask bytes of a lane's 16 flag bits.
__device__ __forceinline__ uint4 spread16(uint32_t f) {
  return make_uint4(spread4(f & 15), spread4((f >> 4) & 15), spread4((f >> 8) & 15),
                    spread4((f >> 12) & 15));
}

template <int kPatWords>
struct WordScanShared {
  uint32_t pat[kPatWords];                      // the pattern, little-endian words, zero past m
  Summary warp_sums[kScanWarps];
  int lead_off[kScanWarps];                     // first_line: block offset of a warp's lead flag
  uint16_t queue[kScanWarps][kStride];          // kLenLong: a warp's candidates in one stride
  uint32_t verified[kScanWarps][kStride / 32];  // ... and the starts that verified
};

struct WordScanArgs {
  const uint8_t* text;
  int m, icase, true_len, prev_word, start_limit;
  uint8_t* mask;
  int* stats;
};

// Bytes 8..m-1 of the candidate start at `s` (its first 8 passed the
// filter) against the pattern words, 4 at a time from aligned text words, of
// which none lies past the word of s[m - 1]; then the -w bytes before and
// after. `at_zero`: s is global offset 0, whose before-byte flag is `before0`.
template <bool kWord>
__device__ __forceinline__ bool verify_rest(const uint8_t* s, bool at_zero, const uint32_t* pat,
                                            int m, bool icase, int before0) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s + 8);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const uint32_t* last =
      reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(s + m - 1) & ~uintptr_t(3));
  const uint32_t sh = 8 * uint32_t(a & 3);
  uint32_t lo = icase ? fold4(w[0]) : w[0];
  for (int i = 0; 8 + 4 * i < m; ++i) {
    const uint32_t* q = w + i + 1 < last ? w + i + 1 : last;  // past `last`: bytes beyond m
    const uint32_t hi = icase ? fold4(*q) : *q;
    uint32_t x = __funnelshift_r(lo, hi, sh) ^ pat[2 + i];
    const int rem = m - 8 - 4 * i;
    if (rem < 4) x &= (1u << (8 * rem)) - 1;
    if (x) return false;
    lo = hi;
  }
  if (kWord) {
    const int before = at_zero ? before0 : is_word(s[-1]);
    return !before && !is_word(s[m]);
  }
  return true;
}

// The verify of a stride's candidates (kLenLong): the warp's candidates go
// to its queue in lane order (a scan of the lanes' counts places them), its
// 32 lanes verify them 32 at a time, so a warp runs as many rounds as its
// lanes have candidates on average, not as its busiest lane has; each
// verified start sets its bit in the warp's stride bitmap, from which each
// lane takes its own 16 bits back. `lo`: this lane's block offset; `so`:
// the stride's.
template <bool kWord>
__device__ __forceinline__ uint32_t verify_long(uint32_t cand, int lo, int so, const uint8_t* block,
                                                bool block0, const uint32_t* pat, int m, bool icase,
                                                int before0, uint16_t* queue, uint32_t* verified) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(cand);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kAll, incl, 31);
  for (int o = incl - n; cand; cand &= cand - 1) queue[o++] = uint16_t(lo + __ffs(cand) - 1);
  if (lane < kStride / 32) verified[lane] = 0;
  __syncwarp();
  for (int q = lane; q < total; q += 32) {
    const int p = queue[q];
    if (verify_rest<kWord>(block + p, block0 && p == 0, pat, m, icase, before0))
      atomicOr(&verified[(p - so) >> 5], 1u << (p & 31));
  }
  __syncwarp();
  const uint32_t v = (verified[lane >> 1] >> (16 * (lane & 1))) & 0xFFFFu;
  __syncwarp();  // the next stride rewrites the queue and the bitmap
  return v;
}

// One block's scan: the stats row (count, first, trail, lead, has_nl, then
// with kFirstLineMask the text offset of the block's lead flag, -1 if none,
// else 0; then 0, 0) and, with a mask kind, its 64 KiB of 0/1 mask bytes.
// Starts lie at or before min(true_len - m, start_limit - 1), and only
// newlines below start_limit count. sh.pat must hold the pattern (folded
// for -i) before the call. kLines = false counts matches alone (word 0).
template <int kLen, bool kWord, int kMask, bool kLines, int kPatWords>
__device__ __forceinline__ void word_scan_block(const WordScanArgs& a,
                                                WordScanShared<kPatWords>& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int base = blockIdx.x * kBlockBytes;  // staged arrays stay below 2 GiB
  const uint8_t* block = a.text + size_t(base);
  int* out = a.stats + blockIdx.x * kStatWords;
  if (a.start_limit <= base) {  // no owned byte: no starts, no newlines
    if (kMask != kNoMask) {
      uint4* dst = reinterpret_cast<uint4*>(a.mask + size_t(base));
      for (int i = t; i < kBlockBytes / 16; i += kThreads) dst[i] = make_uint4(0, 0, 0, 0);
    }
    if (t < kStatWords) out[t] = kMask == kFirstLineMask && t == 5 ? -1 : 0;
    return;
  }
  const int m = a.m;
  const bool icase = a.icase;
  const int hit_end = min(a.true_len - m, a.start_limit - 1) - base + 1;  // starts lie below it
  const int nl_end = a.start_limit - base;  // newlines that count lie below it
  const uint32_t p0 = sh.pat[0], p1 = sh.pat[1];
  const uint32_t m0 = m >= 4 ? kAll : (1u << (8 * m)) - 1;
  const uint32_t m1 = m >= 8 ? kAll : m <= 4 ? 0u : (1u << (8 * (m - 4))) - 1;
  const int warp_off = warp * kWarpBytes;
  uint32_t carry_w = 0;  // -w flag of the byte before the lane's 16 (lane 0's; folding keeps it)
  if (kWord && kLen != kLenLong)
    carry_w = base + warp_off > 0 ? is_word(block[warp_off - 1]) : a.prev_word;

  const uint4* src = reinterpret_cast<const uint4*>(block + warp_off) + lane;
  uint4 cur = src[0], nxt = src[32];
  if (icase) {
    cur = fold16(cur);
    nxt = fold16(nxt);
  }
  uint32_t wb_cur = kWord && kLen != kLenLong ? word_bits16(cur) : 0u;  // -w: this lane's flags
  Summary s = {0, 0, 0, 0, 0};
  uint32_t state = 0;     // the open line already has a match
  bool lead_open = true;  // no match and no newline yet in the warp's span
  int lead_off = -1;
#pragma unroll 1
  for (int k = 0; k < kStrides; ++k) {
    const int so = warp_off + k * kStride;  // block offset of the stride
    const int lo = so + 16 * lane;          // ... and of this lane's 16 bytes
    // two strides ahead; past the warp's span only lane 0 reads: the head of
    // the next warp's span, or the 16 bytes after the block (staged tail)
    uint4 ahead = make_uint4(0, 0, 0, 0);
    if (k + 2 < kStrides || (k + 2 == kStrides && lane == 0)) ahead = src[32 * (k + 2)];

    // 1. The hit word: a masked compare of the window at each position.
    const int nb = (lane + 1) & 31;
    const uint32_t n0 = __shfl_sync(kAll, lane == 0 ? nxt.x : cur.x, nb);
    const uint32_t n1 = kLen != kLen4 ? __shfl_sync(kAll, lane == 0 ? nxt.y : cur.y, nb) : 0u;
    const uint32_t W[6] = {cur.x, cur.y, cur.z, cur.w, n0, n1};
    uint32_t hits = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = j >> 2, sh8 = 8 * (j & 3);
      bool ok = ((__funnelshift_r(W[i], W[i + 1], sh8) ^ p0) & m0) == 0;
      if (kLen != kLen4) ok &= ((__funnelshift_r(W[i + 1], W[i + 2], sh8) ^ p1) & m1) == 0;
      hits |= uint32_t(ok) << j;
    }
    uint32_t nl_own = 0xFFFFu;
    if (so + kStride > hit_end) {  // the stride holds the last start or the start limit
      hits &= low_bits16(hit_end - lo);
      nl_own = low_bits16(nl_end - lo);
    }
    if (kWord && kLen != kLenLong) {
      // word flags of bytes -1 .. 15 + m as bits: this lane's (made one
      // stride ahead), the next lane's first 8 (lane 31: the next stride's
      // lane 0's) and the previous lane's last (lane 0: the previous stride's)
      const uint32_t wb_nxt = word_bits16(nxt);
      const uint32_t wb =
          wb_cur | (__shfl_sync(kAll, lane == 0 ? wb_nxt : wb_cur, nb) & 0xFFu) << 16;
      const uint32_t up = __shfl_up_sync(kAll, wb_cur, 1);
      const uint32_t before = lane ? (up >> 15) & 1 : carry_w;
      carry_w = __shfl_sync(kAll, (wb_cur >> 15) & 1, 31);
      hits &= ~((wb << 1) | before) & ~(wb >> m);
      wb_cur = wb_nxt;
    }
    if (kLen == kLenLong && __any_sync(kAll, hits))
      hits = verify_long<kWord>(hits, lo, so, block, base == 0, sh.pat, m, icase, a.prev_word,
                                sh.queue[warp], sh.verified[warp]);

    // 2. Lines: the state entering each lane from the warp's ballots of the
    //    lanes' (trail, has newline), then fold_bits's carry trick on 16 bits.
    uint32_t flags = hits;
    s.count += __popc(hits);
    if (kLines) {
      const uint32_t nl = (newline_bits4(cur.x) | newline_bits4(cur.y) << 4 |
                           newline_bits4(cur.z) << 8 | newline_bits4(cur.w) << 12) & nl_own;
      const uint32_t gen = hits & ~nl, prop = ~nl & 0xFFFFu;
      const uint32_t s0 = gen + prop;  // entering on a closed line; bit 16: the trail
      const uint32_t T = __ballot_sync(kAll, s0 >> 16), N = __ballot_sync(kAll, nl != 0);
      const uint32_t D = (T | N) & ((1u << lane) - 1);  // earlier lanes that decide the state
      const uint32_t enter = D ? (T >> (31 - __clz(D))) & 1 : state;
      const uint32_t open = (s0 + enter) ^ gen ^ prop;  // bit j: the line open at j has a match
      const uint32_t first = hits & ~open;
      s.first += __popc(first);
      if (kMask == kFirstLineMask) flags = first;
      // the warp's lead: its first match, if at or before its first newline
      if (lead_open) {  // warp-uniform
        const uint32_t upto = nl ? nl ^ (nl - 1) : 0xFFFFu;  // through the lane's first newline
        const uint32_t L = __ballot_sync(kAll, (hits & upto) != 0) & (N ? N ^ (N - 1) : kAll);
        if (L) {
          s.lead = 1;
          if (kMask == kFirstLineMask) {
            const int ll = __ffs(L) - 1;
            lead_off = so + 16 * ll + __ffs(__shfl_sync(kAll, hits, ll)) - 1;
          }
        }
        lead_open = !L && !N;
      }
      const uint32_t DA = T | N;
      if (DA) state = (T >> (31 - __clz(DA))) & 1;
      s.has_nl |= N != 0;
    }
    if (kMask != kNoMask)
      *reinterpret_cast<uint4*>(a.mask + size_t(base) + lo) = spread16(flags);

    cur = nxt;
    nxt = icase ? fold16(ahead) : ahead;
  }
  s.trail = state;

  // 3. The warps' summaries in order; first_line clears a warp's lead flag
  //    where an earlier warp of the block leaves its line open with a match.
  s.count = __reduce_add_sync(kAll, s.count);
  s.first = __reduce_add_sync(kAll, s.first);
  if (lane == 0) {
    sh.warp_sums[warp] = s;
    sh.lead_off[warp] = lead_off;
  }
  __syncthreads();
  if (kMask == kFirstLineMask && lane == 0 && lead_off >= 0) {
    for (int u = warp - 1; u >= 0; --u) {
      if (sh.warp_sums[u].trail) {
        a.mask[size_t(base) + lead_off] = 0;
        break;
      }
      if (sh.warp_sums[u].has_nl) break;
    }
  }
  if (t == 0) {
    Summary b = sh.warp_sums[0];
    for (int w = 1; w < kScanWarps; ++w) b = combine(b, sh.warp_sums[w]);
    int lead = -1;  // the block's lead flag: the lead of its first warp with a match or newline
    for (int w = 0; kMask == kFirstLineMask && w < kScanWarps; ++w) {
      if (sh.warp_sums[w].lead) {
        lead = base + sh.lead_off[w];
        break;
      }
      if (sh.warp_sums[w].has_nl) break;
    }
    out[0] = b.count;
    out[1] = b.first;
    out[2] = b.trail;
    out[3] = b.lead;
    out[4] = b.has_nl;
    out[5] = kMask == kFirstLineMask ? lead : 0;
    out[6] = out[7] = 0;
  }
}

}  // namespace
