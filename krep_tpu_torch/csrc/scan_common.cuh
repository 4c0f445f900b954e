// Pieces shared by the port's scan kernels (swar_scan.cu, multi_scan.cu,
// lines_scan.cu, hamming_scan.cu, byte_scan.cu): the 64 KiB block geometry, the
// line-accounting summary and its ordered fold (byte by byte, or 32
// positions at a time from bit words), the ASCII fold, the word-byte test,
// the coalesced store of a start bitmap as a 0/1 byte mask, the fold of a
// launch's block summaries by its own last blocks (finish_blocks, with the
// first-line fix-up of clear_entering_leads), the line
// fold of a warp's stride from its hit and newline bit words
// (fold_lines16, which the word scan and the lines kernel share), and the
// word scan of one pattern that swar_scan.cu and byte_scan.cu both run
// (word_scan_block, at the end).
//
// finish_blocks replaces a second launch (the standalone combine_blocks of
// swar_scan.cu, one block that folded every row: 0.045 ms at 16,384 rows
// on an H100, mostly its launch and one SM's dependent loads). Thread 0 of
// each block writes the block's row and draws a ticket from its group's
// counter (64 blocks a group) with an atomic add that releases the row and
// acquires the rows of the adders before it; the block that draws a
// group's last ticket folds the group's rows, read from L2 (__ldcg: the
// rows come from other SMs, so no L1 line of them can be stale), into a
// group row and draws a ticket from the launch's counter the same way; the block that draws
// the last of those folds the group rows into the totals. The counters and
// the group rows are one int32 scratch per (device, stream), zeroed once by
// the wrapper (ops/swar.py) and left at zero by the blocks that complete
// them, so the next launch finds them at zero: launches on one stream run
// one after another, launches on two streams use two scratches, and a
// fault inside a launch leaves a sticky context error, so no later launch
// can read a counter that was left half counted. A block with nothing to
// scan (past start_limit) still writes its row and draws its ticket, or
// its group would never fold. In the first_line instances the block that
// folds the totals also finishes the first-line mask across blocks
// (clear_entering_leads), which replaces a second launch too
// (first_line_fixup: 0.0214 ms at 1,536 rows on an H100, PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockBytes = 65536;                // staged bytes per CUDA block
constexpr int kThreads = 256;
constexpr int kSpan = kBlockBytes / kThreads;     // contiguous bytes per thread
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

// Newline flags of a lane's 16 bytes, as bits 0..15.
__device__ __forceinline__ uint32_t newline_bits16(uint4 v) {
  return newline_bits4(v.x) | newline_bits4(v.y) << 4 | newline_bits4(v.z) << 8 |
         newline_bits4(v.w) << 12;
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

// Writes a summary as a row of 8 int32: count, first, trail, lead, has_nl,
// then `word5`, 0, 0.
__device__ __forceinline__ void write_row(int* out, const Summary& b, int word5) {
  out[0] = b.count;
  out[1] = b.first;
  out[2] = b.trail;
  out[3] = b.lead;
  out[4] = b.has_nl;
  out[5] = word5;
  out[6] = out[7] = 0;
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
    write_row(stats + blockIdx.x * kStatWords, b, 0);
  }
}

// The scan tail's scratch, one int32 array per (device, stream) that the
// wrapper zeroes once (ops/swar.py tail_scratch): each group's folded row
// (kStatWords words, 16-byte aligned for load_row), then each group's count
// of finished blocks, then the count of groups whose fold is done. Groups
// of kGroupBlocks blocks; a launch has at most 2 GiB of 64 KiB blocks.
constexpr int kGroupBlocks = 64;
constexpr int kMaxTailGroups = (1u << 31) / kBlockBytes / kGroupBlocks;  // 512
constexpr int kTailCounters = kMaxTailGroups * kStatWords;  // the first counter's word
constexpr int kTailWords = kTailCounters + kMaxTailGroups + 1;

// A launch's scan-tail arguments: no totals, or totals and a scratch for
// at most 2 GiB of blocks.
inline bool tail_ok(int nblocks, const void* totals, const void* scratch) {
  return !totals || (scratch && nblocks <= kMaxTailGroups * kGroupBlocks);
}

// Words 0..4 of a row written by another block, from L2 (__ldcg: no L1
// line of it can be stale).
__device__ __forceinline__ Summary load_row(const int* r) {
  const int4 a = __ldcg(reinterpret_cast<const int4*>(r));
  return Summary{a.x, a.y, a.z, a.w, __ldcg(r + 4)};
}

// Folds n <= 2 * kThreads rows of kStatWords ints in text order, in
// passes of kThreads rows: thread t row r0 + t, then warp_fold, then the
// warps' sums in order onto the passes before. The result is thread 0's.
// Every thread calls it. One row a thread: with two it lifted the word
// scan's registers by up to 12 (one block fewer per SM, 5 % on the count,
// PERF.md).
__device__ __forceinline__ Summary fold_rows_inline(const int* rows, int n,
                                                    Summary* warp_sums) {
  const int t = threadIdx.x;
  Summary b = {0, 0, 0, 0, 0};  // the empty summary is neutral on both sides
  for (int r0 = 0; r0 < n; r0 += kThreads) {
    Summary s = {0, 0, 0, 0, 0};
    if (r0 + t < n) s = load_row(rows + (r0 + t) * kStatWords);
    s = warp_fold(s);
    __syncthreads();  // the previous pass's (or the caller's) warp sums are read
    if ((t & 31) == 0) warp_sums[t >> 5] = s;
    __syncthreads();
#pragma unroll 1
    for (int w = 0; w < kThreads / 32; ++w) b = combine(b, warp_sums[w]);
  }
  return b;
}

// fold_rows_inline behind a call. Which of the two a kernel takes was
// measured (PERF.md): the word scans run 2-6 % slower with the fold
// inlined (at one call site or two), though a call costs a kernel its
// uniform datapath (its ballots go to per-thread registers behind
// divergence checks, BRA.DIV); the K-pattern scan's shard instances run
// 5-6 % slower with the call.
__device__ __noinline__ Summary fold_rows_call(const int* rows, int n, Summary* warp_sums) {
  return fold_rows_inline(rows, n, warp_sums);
}

template <bool kCall>
__device__ __forceinline__ Summary fold_rows(const int* rows, int n, Summary* warp_sums) {
  if constexpr (kCall) return fold_rows_call(rows, n, warp_sums);
  else return fold_rows_inline(rows, n, warp_sums);
}

// Adds 1 to *counter with release and acquire semantics at device scope:
// this thread's earlier writes are visible to the device before the add,
// and what the earlier adders wrote before theirs is visible after it (to
// the block, after a barrier). Returns the count before the add.
__device__ __forceinline__ int ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// The line state across a block row (whether the line open after it has a
// match), as a map of the state entering it: s -> has_nl ? trail : (s |
// trail), two bits: kPass (no newline: s passes) and kSet (trail). kPass
// alone is the identity; maps compose in text order (map_then).
constexpr uint32_t kPass = 1u, kSet = 2u;

__device__ __forceinline__ uint32_t row_map(const int* r) {
  return (__ldcg(r + 4) ? 0u : kPass) | (__ldcg(r + 2) ? kSet : 0u);  // words 4, 2 (L2)
}

// x, then y: passes where both pass; sets where x sets and y passes, or y sets.
__device__ __forceinline__ uint32_t map_then(uint32_t x, uint32_t y) {
  return (x & (y | (y << 1)) & 3u) | (y & kSet);
}

__device__ __forceinline__ uint32_t map_apply(uint32_t m, uint32_t s) {
  return ((s & m) | (m >> 1)) & 1u;
}

// Inclusive (returned) and exclusive (`ex`) scans of the lanes' maps in lane order.
__device__ __forceinline__ uint32_t warp_scan_maps(uint32_t v, uint32_t& ex) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = map_then(u, v);
  }
  ex = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) ex = kPass;
  return v;
}

// The first-line fix-up, run by the launch's last block once every block
// row and group row is in (finish_blocks): clears the lead flag (the byte
// at text offset stats word 5, -1 if none) of each block whose entering
// line already has a match, as lines.first_line_fixup does. Each block's
// entering state is an exclusive scan of the row maps: first over the group
// rows (two groups a thread, ngroups <= kMaxTailGroups), then each warp
// takes whole groups, two rows a lane, and scans them from its group's
// entering state. Every thread of the block calls it.
__device__ __forceinline__ void clear_entering_leads(const int* stats, int n,
                                                     const int* group_rows, int ngroups,
                                                     uint8_t* mask) {
  __shared__ uint32_t warp_maps[kThreads / 32];
  __shared__ uint8_t group_in[kMaxTailGroups];  // the line entering group g has a match
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t g0 = 2 * t < ngroups ? row_map(group_rows + 2 * t * kStatWords) : kPass;
  const uint32_t g1 = 2 * t + 1 < ngroups ? row_map(group_rows + (2 * t + 1) * kStatWords) : kPass;
  uint32_t ex;
  const uint32_t inc = warp_scan_maps(map_then(g0, g1), ex);
  if (lane == 31) warp_maps[warp] = inc;
  __syncthreads();
  uint32_t pre = kPass;
  for (int w = 0; w < warp; ++w) pre = map_then(pre, warp_maps[w]);
  const uint32_t s0 = map_apply(map_then(pre, ex), 0u);
  if (2 * t < ngroups) group_in[2 * t] = uint8_t(s0);
  if (2 * t + 1 < ngroups) group_in[2 * t + 1] = uint8_t(map_apply(g0, s0));
  __syncthreads();
  for (int g = warp; g < ngroups; g += kThreads / 32) {
    const int r0 = g * kGroupBlocks + 2 * lane;
    const uint32_t x0 = r0 < n ? row_map(stats + r0 * kStatWords) : kPass;
    const uint32_t x1 = r0 + 1 < n ? row_map(stats + (r0 + 1) * kStatWords) : kPass;
    const int lead0 = r0 < n ? __ldcg(stats + r0 * kStatWords + 5) : -1;  // loaded beside the maps
    const int lead1 = r0 + 1 < n ? __ldcg(stats + (r0 + 1) * kStatWords + 5) : -1;
    warp_scan_maps(map_then(x0, x1), ex);
    const uint32_t s = map_apply(ex, group_in[g]);
    if (s && lead0 >= 0) mask[lead0] = 0;
    if (map_apply(x0, s) && lead1 >= 0) mask[lead1] = 0;
  }
}

// The end of every summary-writing launch: every thread of every block
// calls it once the block's thread 0 has written the block's row (stats +
// blockIdx.x * kStatWords). Two levels of tickets: the block that finishes
// its group of kGroupBlocks blocks last folds the group's rows into the
// group's row in `scratch`; the block that finishes the last group folds
// the group rows into the 8 totals [count, matched lines, trail, lead,
// has_nl, 0, 0, 0]. Each finisher resets the counter it completed (the
// note at the top has the argument). The thread that wrote a row draws
// its ticket with release semantics (ticket), and no thread fences: a
// __threadfence in every thread cost the K-pattern scan (two blocks an
// SM) 1.4 % at 1 GiB, one in thread 0 still 0.8 %. One level, the last
// block folding every row alone, each thread a run of rows, took 0.021 ms
// at 16,384 rows and 0.038 ms at 24,576 on an H100 (PERF.md): one SM read
// every row from L2, 32 lanes at 32 rows' distance a load. totals ==
// nullptr: no fold (the cost-attribution variants of byte_scan.cu).
// `warp_sums`: kThreads / 32 summaries of shared memory that the block no
// longer reads. kCall: fold through a call (fold_rows_call: the word scans
// and the lines kernel), else inline (the K-pattern scan).
//
// kLeads (the first_line instances of swar_scan.cu): with `fix_mask` set,
// the block that folds the totals then finishes the first-line mask
// (clear_entering_leads), so no second launch is needed. The byte it
// clears was written as 1 by another block, by any of its threads (the
// lane whose 16 bytes hold the lead), so the clear must be ordered after
// that store: in kLeads every block passes a barrier before its thread 0
// draws the group ticket, so the release of that atom.acq_rel.gpu covers
// the stores of every thread of the block (the barrier orders them before
// it at block scope, and release is cumulative); the group's finisher
// acquires them with its ticket, releases them again with its ticket on
// the launch counter, and the last block acquires that and passes a
// barrier before any of its threads clears a byte. The block's own clears
// inside the block (word_scan_block, after its barrier) touch other bytes
// (the leads of later warps), and the lead of a block is never cleared
// there.
template <bool kCall = true, bool kLeads = false>
__device__ __forceinline__ void finish_blocks(const int* stats, int* totals, int* scratch,
                                              Summary* warp_sums, uint8_t* fix_mask = nullptr) {
  __shared__ int last;
  if (!totals) return;
  const int t = threadIdx.x, n = gridDim.x;
  const int g = blockIdx.x / kGroupBlocks, g0 = g * kGroupBlocks;
  const int ngroups = (n + kGroupBlocks - 1) / kGroupBlocks;
  int* group_rows = scratch;
  int* group_count = scratch + kTailCounters;
  int* groups_done = group_count + kMaxTailGroups;
  if constexpr (kLeads) __syncthreads();  // every thread's mask stores, before the release
  if (t == 0) last = ticket(group_count + g) == min(kGroupBlocks, n - g0) - 1;  // the row's writer
  __syncthreads();
  if (!last) return;
  Summary s = fold_rows<kCall>(stats + g0 * kStatWords, min(kGroupBlocks, n - g0), warp_sums);
  if (t == 0) {
    write_row(group_rows + g * kStatWords, s, 0);
    group_count[g] = 0;
    last = ticket(groups_done) == ngroups - 1;
  }
  __syncthreads();
  if (!last) return;
  s = fold_rows<kCall>(group_rows, ngroups, warp_sums);
  if (t == 0) {
    write_row(totals, s, 0);
    *groups_done = 0;
  }
  if constexpr (kLeads) {
    if (fix_mask) clear_entering_leads(stats, n, group_rows, ngroups, fix_mask);
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
// -c dedup flags (the first match of each line; each block makes them as if
// it began on a closed line, and the launch's last block finishes them
// across blocks: finish_blocks' kLeads).
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

// A warp's line state over its walk: its summary (count left to the
// caller, trail set at the end from `state`), the open line's flag, whether
// the warp has met no match and no newline yet, and (first_line) the block
// offset of its lead flag, -1 if none.
struct WarpLines {
  Summary s = {0, 0, 0, 0, 0};
  uint32_t state = 0;
  bool lead_open = true;
  int lead_off = -1;
};

// The line fold of one stride (step 2 of word_scan_block, and the lines
// kernel's whole work): each lane's 16 start flags `hits` and the newlines
// that count `nl`, bit j for position j of the lane's 16 bytes at block
// offset so + 16 * lane. The state entering each lane comes from the
// warp's ballots of the lanes' (trail, has newline), then fold_bits's carry
// trick on 16 bits. Returns the lane's first-in-line flags (exact as if the
// warp's span began on a closed line). kLeadOff: record the lead's offset.
template <bool kLeadOff>
__device__ __forceinline__ uint32_t fold_lines16(WarpLines& w, uint32_t hits, uint32_t nl, int so) {
  const int lane = threadIdx.x & 31;
  const uint32_t gen = hits & ~nl, prop = ~nl & 0xFFFFu;
  const uint32_t s0 = gen + prop;  // entering on a closed line; bit 16: the trail
  const uint32_t T = __ballot_sync(kAll, s0 >> 16), N = __ballot_sync(kAll, nl != 0);
  const uint32_t D = (T | N) & ((1u << lane) - 1);  // earlier lanes that decide the state
  const uint32_t enter = D ? (T >> (31 - __clz(D))) & 1 : w.state;
  const uint32_t open = (s0 + enter) ^ gen ^ prop;  // bit j: the line open at j has a match
  const uint32_t first = hits & ~open;
  w.s.first += __popc(first);
  // the warp's lead: its first match, if at or before its first newline
  if (w.lead_open) {  // warp-uniform
    const uint32_t upto = nl ? nl ^ (nl - 1) : 0xFFFFu;  // through the lane's first newline
    const uint32_t L = __ballot_sync(kAll, (hits & upto) != 0) & (N ? N ^ (N - 1) : kAll);
    if (L) {
      w.s.lead = 1;
      if (kLeadOff) {
        const int ll = __ffs(L) - 1;
        w.lead_off = so + 16 * ll + __ffs(__shfl_sync(kAll, hits, ll)) - 1;
      }
    }
    w.lead_open = !L && !N;
  }
  const uint32_t DA = T | N;
  if (DA) w.state = (T >> (31 - __clz(DA))) & 1;
  w.s.has_nl |= N != 0;
  return first;
}

// The warps' line summaries in order: count and first summed over the
// lanes, lane 0's summary into warp_sums; then the block's fold, by thread
// 0, of warp_sums (after a barrier).
__device__ __forceinline__ void put_warp_summary(Summary s, Summary* warp_sums) {
  s.count = __reduce_add_sync(kAll, s.count);
  s.first = __reduce_add_sync(kAll, s.first);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
}

__device__ __forceinline__ Summary fold_warps(const Summary* warp_sums) {
  Summary b = warp_sums[0];
  for (int w = 1; w < kScanWarps; ++w) b = combine(b, warp_sums[w]);
  return b;
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
    if (t == 0) write_row(out, Summary{0, 0, 0, 0, 0}, kMask == kFirstLineMask ? -1 : 0);
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
  WarpLines lines;
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

    // 2. Lines: fold_lines16 on the hit and newline words.
    uint32_t flags = hits;
    lines.s.count += __popc(hits);
    if (kLines) {
      const uint32_t first =
          fold_lines16<kMask == kFirstLineMask>(lines, hits, newline_bits16(cur) & nl_own, so);
      if (kMask == kFirstLineMask) flags = first;
    }
    if (kMask != kNoMask)
      *reinterpret_cast<uint4*>(a.mask + size_t(base) + lo) = spread16(flags);

    cur = nxt;
    nxt = icase ? fold16(ahead) : ahead;
  }
  lines.s.trail = lines.state;

  // 3. The warps' summaries in order; first_line clears a warp's lead flag
  //    where an earlier warp of the block leaves its line open with a match.
  put_warp_summary(lines.s, sh.warp_sums);
  if (lane == 0) sh.lead_off[warp] = lines.lead_off;
  __syncthreads();
  if (kMask == kFirstLineMask && lane == 0 && lines.lead_off >= 0) {
    for (int u = warp - 1; u >= 0; --u) {
      if (sh.warp_sums[u].trail) {
        a.mask[size_t(base) + lines.lead_off] = 0;
        break;
      }
      if (sh.warp_sums[u].has_nl) break;
    }
  }
  if (t == 0) {
    int lead = -1;  // the block's lead flag: the lead of its first warp with a match or newline
    for (int w = 0; kMask == kFirstLineMask && w < kScanWarps; ++w) {
      if (sh.warp_sums[w].lead) {
        lead = base + sh.lead_off[w];
        break;
      }
      if (sh.warp_sums[w].has_nl) break;
    }
    write_row(out, fold_warps(sh.warp_sums), kMask == kFirstLineMask ? lead : 0);
  }
}

}  // namespace
