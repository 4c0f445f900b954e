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
// What bounds it on the card: not bytes (each text byte is read once, the
// mask written once: 0.32 ms per GiB of 3.35 TB/s) but the work per start
// position, as in the TPU kernel. Measured on an H100 (PERF.md): 1.2-1.3 ms
// per GiB of a-z text, where only the filter works (about 0.4 ms of it per
// probe of the map, the rest the copy and the line fold), and 2.5 / 5.1 ms
// per GiB of bench.py's corpus at K = 16 / 64, a match every 6 bytes: the
// verify of about 0.2 G (position, member) items. The first design walked
// each thread's 256 bytes one at a time and, at every byte whose first byte
// starts some pattern, looped over that byte's bucket with a byte compare
// and an early exit: on bench.py's corpus some lane of every warp has such
// a byte at nearly every step, so the warp ran the union of its lanes'
// loops and the time grew with K (10.8 / 34.4 ms at K = 16 / 64 per GiB).
// This design takes the TPU kernel's shape, a branch-free filter over every
// position and then a verify, and spreads the verify over the warp:
//   * one CUDA block per 64 KiB of staged text plus its 64-byte tail, copied
//     (folded for -i) into shared memory in rows of 272 bytes: a thread's
//     256 bytes and a copy of the next row's first 16, so a thread reads its
//     span 16 bytes at a time without bank conflicts and its last windows
//     without leaving the row;
//   * the filter: each member is keyed by its first l = min(m, 4) bytes. For
//     every position a thread forms the 4-byte window with a funnel shift
//     and, for each prefix length the set has (warp-uniform), tests one bit
//     of a 2^15-bit map, at a multiplicative hash of the window's first l
//     bytes. The probes are random shared-memory words (about 3.5-way bank
//     conflicts, some 0.4 ms per GiB each on an H100), so in a set with
//     lengths 3 and 4 (most sets) the two share one word per position: the
//     word comes from the 3-byte hash and each length's bit from its own. The
//     hits of 32 positions form one candidate word per length; there is no
//     branch on the data;
//   * the verify, in warp rounds: the warp's candidates go to a queue in
//     shared memory (a scan of the lanes' counts places them), and each
//     round its 32 lanes take the next 32, so the rounds follow the warp's
//     mean candidate count, not its busiest lane's. A candidate's bucket
//     (the top 8 bits of its key times a multiplier that the host picks
//     for the set, so that members of different prefixes rarely share one)
//     lists the members of that prefix length. When every lane's bucket
//     holds at most one member, each lane verifies its own; otherwise the
//     warp scans the bucket sizes and its 32 lanes take the (position,
//     member) items 32 at a time, each finding its candidate by a binary
//     search over the scan with shuffles. A verify
//     compares 4 bytes at a time with the member's words (the last masked by
//     its length), applies the true_len bound and the -w tests, counts the
//     item and sets the start's bit in the block's 8 KiB hit bitmap;
//   * the line accounting on bits: a thread's newlines come 4 at a time from
//     __vcmpeq4 on its words, and its 32-position words of hits and
//     newlines fold into its summary with one add and a few popc (fold_bits),
//     then the 256 summaries fold in order as before;
//   * the mask instance expands the bitmap into 16-byte stores, consecutive
//     threads at consecutive addresses (store_mask_bits);
//   * the launch's block summaries fold in text order inside the launch,
//     by the last blocks to finish (scan_common.cuh finish_blocks), which
//     write the totals beside the rows; a block past the shard limit still
//     takes its part;
//   * -i, -w, the mask and the shard mode are template arguments (16
//     instances, picked by krep_scan_blocks_multi): the hot loops test none
//     of them at run time. The shard mode (kShard, for `scan_shard_multi`
//     :1127, the sharded route of parallel/mesh.py) bounds every pattern's
//     starts, and the newlines that count, to [0, start_limit): a block
//     wholly past the limit writes zeros and stops, a warp runs only the
//     32-position groups its first thread owns, and the group that holds
//     the limit masks its candidate and newline words once.
// The tables (filter map, buckets, member words) are built on the host by
// ops/swar.py `multi_tables` once per set and kept on the card; each block
// copies them into shared memory. -w tests each pattern's own after-byte
// and the byte before directly (not the TPU kernel's SWAR borrow, which
// drops matches after "_^"); prev_word is the -w flag of the byte before
// the text (the previous shard's last byte), read for block 0.
//
// stats[0] counts (position, member) matches, not mask bytes: the mask
// readback (ops/dispatch.py starts_from_device_mask) only tests group counts
// for zero, and a block has a match exactly when its mask has a set byte.

#include "scan_common.cuh"

namespace {

constexpr int kMaxPatterns = 64;
constexpr int kRowM = kSpan + 16;                       // a span + the next row's first 16 bytes
constexpr int kTailRow = kTail + 16;
constexpr int kTextBytes = kThreads * kRowM + kTailRow;     // 69,712
constexpr int kHitBytes = kBlockBytes / 8;                  // one bit per start position
constexpr int kMapBits = 15;
constexpr int kBucketBits = 8;
constexpr int kBuckets = 1 << kBucketBits;                  // per prefix length
constexpr int kGroups = kSpan / 32;                         // 32-position words per span
constexpr int kQueue = 32 * 32;                             // a warp's candidates of one group
constexpr unsigned kFull = 0xffffffffu;

// Built by ops/swar.py `multi_tables` (the byte layout is fixed there too).
struct MultiTables {
  uint32_t map[(1 << kMapBits) / 32];         // the filter: see filter, filter34, swar.map_bit
  uint32_t words[kMaxPattern / 4][kMaxPatterns];  // word i of member k (folded, zero past m)
  uint8_t len[kMaxPatterns];
  uint8_t list[kMaxPatterns];                 // member indices by (prefix length l, bucket b)
  uint8_t bucket_off[4 * kBuckets + 16];      // list[off[i] .. off[i+1]): i = 256 (l-1) + b
  uint32_t bucket_mult[4];                    // b: top 8 bits of key * bucket_mult[l-1]
  uint32_t present;                           // bit l-1: some member has prefix length l
  uint32_t pad[3];
};
static_assert(sizeof(MultiTables) == 9392, "MultiTables layout is shared with ops/swar.py");
static_assert(sizeof(MultiTables) % 16 == 0 && kTextBytes % 16 == 0, "16-byte copies");
constexpr int kQueueBytes = kThreads / 32 * kQueue * 2;     // 16 KiB: one uint16 queue per warp
constexpr int kMultiSmem = kTextBytes + kHitBytes + int(sizeof(MultiTables)) + kQueueBytes;

// The prefix hash of length l: the window's first l bytes (little-endian)
// times an odd constant of l, mod 2^32 (ops/swar.py HASH_MULT).
__host__ __device__ constexpr uint32_t key_mask(int l) {
  return l == 4 ? 0xFFFFFFFFu : (1u << (8 * l)) - 1;
}
__host__ __device__ constexpr uint32_t hash_mult(int l) {
  return l == 1 ? 0x9E3779B1u : l == 2 ? 0x85EBCA77u : l == 3 ? 0xC2B2AE3Du : 0x27D4EB2Fu;
}

// The aligned text word at block offset o (o % 4 == 0, o < kBlockBytes + kTail).
__device__ __forceinline__ uint32_t word_at(const uint8_t* smem, int o) {
  return *reinterpret_cast<const uint32_t*>(smem + (o >> 8) * kRowM + (o & (kSpan - 1)));
}

__device__ __forceinline__ unsigned byte_at(const uint8_t* smem, int o) {
  return smem[(o >> 8) * kRowM + (o & (kSpan - 1))];
}

struct Ctx {
  const uint8_t* smem;
  const MultiTables* tb;
  uint32_t* hits;
  int room;   // true_len - base: a member of length m starts at most at room - m
  int prev0;  // -w flag of the byte before the block
};

// One (position, member) item: the member's bytes at block offset p, the
// true_len bound and the -w boundaries; counts it and sets p's hit bit.
// An invalid item (valid == false) compares nothing and counts nothing.
template <bool kWord>
__device__ __forceinline__ void verify(const Ctx& c, int p, int k, bool valid, int& count) {
  const int m = valid ? c.tb->len[k] : 0;
  bool ok = valid && p + m <= c.room;
  const int a = p & ~3, sh = 8 * (p & 3);
  uint32_t lo = word_at(c.smem, a);
  for (int i = 0; i < (m + 3) >> 2; ++i) {
    const uint32_t hi = word_at(c.smem, a + 4 * i + 4);
    const uint32_t x = __funnelshift_r(lo, hi, sh) ^ c.tb->words[i][k];
    const int rem = m - 4 * i;
    ok &= (rem >= 4 ? x : x & ((1u << (8 * rem)) - 1)) == 0;
    lo = hi;
  }
  if (kWord) {
    const int before = p > 0 ? is_word(byte_at(c.smem, p - 1)) : c.prev0;
    ok &= !before && !is_word(byte_at(c.smem, p + m));
  }
  if (ok) {
    atomicOr(&c.hits[p >> 5], 1u << (p & 31));
    ++count;
  }
}

// Verifies one candidate per lane: the `cnt` members of the bucket at list
// offset `start` at block offset p (cnt = 0: no candidate). Where every
// lane's bucket holds at most one member, each lane verifies its own;
// otherwise the warp scans the counts and its 32 lanes take the (position,
// member) items 32 at a time, each finding its candidate by a binary
// search over the scan with shuffles.
template <bool kWord>
__device__ __forceinline__ void verify_buckets(const Ctx& c, int p, int start, int cnt,
                                               int& count) {
  if (__all_sync(kFull, cnt <= 1)) {
    verify<kWord>(c, p, c.tb->list[start & (kMaxPatterns - 1)], cnt == 1, count);
    return;
  }
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - cnt;
  const int total = __shfl_sync(kFull, incl, 31);
  const uint32_t packed = uint32_t(p) | (uint32_t(start) << 17);
  for (int s0 = 0; s0 < total; s0 += 32) {
    const int s = s0 + lane;
    int o = 0;  // the last lane whose items begin at or before item s
#pragma unroll
    for (int step = 16; step; step >>= 1)
      if (__shfl_sync(kFull, excl, o + step) <= s) o += step;
    const uint32_t pk = __shfl_sync(kFull, packed, o);
    const int first = __shfl_sync(kFull, excl, o);
    const bool valid = s < total;
    const int e = (pk >> 17) + (valid ? s - first : 0);
    verify<kWord>(c, int(pk & 0xFFFFu), c.tb->list[e & (kMaxPatterns - 1)], valid, count);
  }
}

// The candidate word of prefix length L over a group's 32 positions (w:
// the group's 8 text words and the next one): for each, the map bit
// (h >> 17) % 32 of word h >> 22, h the hash of the window's first L bytes.
template <int L>
__device__ __forceinline__ uint32_t filter(const MultiTables* tb,
                                           const uint32_t (&w)[kGroups + 1]) {
  uint32_t cand = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t win = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));
    const uint32_t h = (win & key_mask(L)) * hash_mult(L);
    const uint32_t m = tb->map[h >> 22];
    cand |= (__funnelshift_r(m, m, h >> 17) & 1u) << j;
  }
  return cand;
}

// The candidate words of prefix lengths 3 and 4, for a set that has both:
// one map word per position, at the 3-byte hash, and each length's bit
// (h >> 17) % 32 at its own hash h.
__device__ __forceinline__ void filter34(const MultiTables* tb, const uint32_t (&w)[kGroups + 1],
                                         uint32_t& cand3, uint32_t& cand4) {
  cand3 = cand4 = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t win = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));
    const uint32_t h3 = (win & key_mask(3)) * hash_mult(3);
    const uint32_t h4 = win * hash_mult(4);
    const uint32_t m = tb->map[h3 >> 22];
    cand3 |= (__funnelshift_r(m, m, h3 >> 17) & 1u) << j;
    cand4 |= (__funnelshift_r(m, m, h4 >> 17) & 1u) << j;
  }
}

// Verify of prefix length L's candidates `cand` in a thread's group (p0:
// the group's block offset). The warp's candidates go to its queue in lane
// order (a scan of the lanes' counts gives each lane its place), and the
// warp takes them 32 at a time, so a warp runs as many verify rounds as its
// lanes have candidates on average, not as its busiest lane has.
template <int L, bool kWord>
__device__ __forceinline__ void verify_candidates(const Ctx& c, uint32_t cand, int p0,
                                                  uint16_t* queue, int& count) {
  if (!__any_sync(kFull, cand)) return;
  const int lane = threadIdx.x & 31;
  const int n = __popc(cand);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  for (int o = incl - n; cand; cand &= cand - 1) queue[o++] = uint16_t(p0 + __ffs(cand) - 1);
  __syncwarp();
  for (int s0 = 0; s0 < total; s0 += 32) {
    const int s = s0 + lane;
    const bool have = s < total;
    const int p = queue[have ? s : s0];
    const uint32_t win = __funnelshift_r(word_at(c.smem, p & ~3), word_at(c.smem, (p & ~3) + 4),
                                         8 * (p & 3));
    const uint32_t h = (win & key_mask(L)) * c.tb->bucket_mult[L - 1];
    const int b = (L - 1) * kBuckets + int(h >> (32 - kBucketBits));
    const int start = c.tb->bucket_off[b];
    verify_buckets<kWord>(c, p, start, have ? c.tb->bucket_off[b + 1] - start : 0, count);
  }
  __syncwarp();  // the next prefix length rewrites the queue
}

template <bool kFold, bool kWord, bool kMask, bool kShard>
__global__ void __launch_bounds__(kThreads, 2)
scan_blocks_multi_kernel(const uint8_t* __restrict__ text, const MultiTables* __restrict__ tables,
                         int true_len, int prev_word, int start_limit,
                         uint8_t* __restrict__ mask, int* __restrict__ stats,
                         int* __restrict__ totals, int* scratch) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint32_t* hits = reinterpret_cast<uint32_t*>(smem + kTextBytes);
  MultiTables* tb = reinterpret_cast<MultiTables*>(smem + kTextBytes + kHitBytes);
  uint16_t* queue =
      reinterpret_cast<uint16_t*>(smem + kTextBytes + kHitBytes + sizeof(MultiTables)) +
      (threadIdx.x >> 5) * kQueue;
  __shared__ Summary warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const int base = blockIdx.x * kBlockBytes;  // staged arrays stay below 2 GiB
  const uint8_t* block = text + size_t(base);

  if (kShard && start_limit <= base) {  // no owned byte: no starts, no newlines
    if (kMask) {
      for (int i = 0; i < kBlockBytes / 16 / kThreads; ++i)
        reinterpret_cast<uint4*>(mask + size_t(base))[i * kThreads + t] = make_uint4(0, 0, 0, 0);
    }
    if (t == 0) write_row(stats + blockIdx.x * kStatWords, Summary{0, 0, 0, 0, 0}, 0);
    finish_blocks<false>(stats, totals, scratch, warp_sums);  // its ticket too
    return;
  }

  // 1. The tables, the block's 64 KiB and the 64-byte tail into shared
  //    memory; each row also gets the next row's first 16 bytes.
  {
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    uint4* dst = reinterpret_cast<uint4*>(tb);
    for (int k = t; k < int(sizeof(MultiTables) / 16); k += kThreads) dst[k] = src[k];
  }
  const uint4* src = reinterpret_cast<const uint4*>(block);
#pragma unroll 4
  for (int k = 0; k < kBlockBytes / 16 / kThreads; ++k) {
    const int chunk = k * kThreads + t;
    uint4 v = src[chunk];
    if (kFold) v = make_uint4(fold4(v.x), fold4(v.y), fold4(v.z), fold4(v.w));
    const int r = chunk >> 4, col = (chunk & 15) * 16;
    *reinterpret_cast<uint4*>(smem + r * kRowM + col) = v;
    if (col == 0 && r > 0) *reinterpret_cast<uint4*>(smem + (r - 1) * kRowM + kSpan) = v;
  }
  if (t < kTail / 16) {
    uint4 v = reinterpret_cast<const uint4*>(block + kBlockBytes)[t];
    if (kFold) v = make_uint4(fold4(v.x), fold4(v.y), fold4(v.z), fold4(v.w));
    *reinterpret_cast<uint4*>(smem + kThreads * kRowM + 16 * t) = v;
    if (t == 0) *reinterpret_cast<uint4*>(smem + (kThreads - 1) * kRowM + kSpan) = v;
  }
  reinterpret_cast<uint4*>(hits)[2 * t] = make_uint4(0, 0, 0, 0);  // this thread's 8 words
  reinterpret_cast<uint4*>(hits)[2 * t + 1] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // 2. Each thread's span, 32 positions at a time: filter, verify, fold.
  Ctx c{smem, tb, hits, true_len - base, 0};
  if (kWord) c.prev0 = blockIdx.x > 0 ? is_word(block[-1]) : prev_word;  // folding keeps word-ness
  const uint8_t* row = smem + t * kRowM;
  const int row_base = t * kSpan;
  const uint32_t present = tb->present;
  int groups = kGroups;
  int own = kSpan;  // bytes of this span below start_limit
  if (kShard) {
    own = start_limit - base - row_base;
    const int own_warp = start_limit - base - (t & ~31) * kSpan;  // the warp's first span
    groups = min(max((own_warp + 31) / 32, 0), kGroups);
  }
  Summary s = {0, 0, 0, 0, 0};
  uint32_t state = 0;
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    const int q0 = 32 * g;
    const uint4 a = *reinterpret_cast<const uint4*>(row + q0);
    const uint4 b = *reinterpret_cast<const uint4*>(row + q0 + 16);
    const uint32_t w[kGroups + 1] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                     *reinterpret_cast<const uint32_t*>(row + q0 + 32)};
    uint32_t own_bits = ~0u;
    if (kShard) {
      const int r = own - q0;
      own_bits = r >= 32 ? ~0u : r <= 0 ? 0u : (1u << r) - 1;
    }
    const int p0 = row_base + q0;
    int& n = s.count;
    if (present & 1u) verify_candidates<1, kWord>(c, filter<1>(tb, w) & own_bits, p0, queue, n);
    if (present & 2u) verify_candidates<2, kWord>(c, filter<2>(tb, w) & own_bits, p0, queue, n);
    if ((present & 12u) == 12u) {
      uint32_t cand3, cand4;
      filter34(tb, w, cand3, cand4);
      verify_candidates<3, kWord>(c, cand3 & own_bits, p0, queue, n);
      verify_candidates<4, kWord>(c, cand4 & own_bits, p0, queue, n);
    } else {
      if (present & 4u) verify_candidates<3, kWord>(c, filter<3>(tb, w) & own_bits, p0, queue, n);
      if (present & 8u) verify_candidates<4, kWord>(c, filter<4>(tb, w) & own_bits, p0, queue, n);
    }
    uint32_t nl = 0;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) nl |= newline_bits4(w[i]) << (4 * i);
    __syncwarp();
    fold_bits(s, state, hits[8 * t + g], nl & own_bits);
  }
  s.trail = state;

  // 3. The union mask from the bitmap, then the block's summary and the
  //    launch's fold in its last block.
  if (kMask) {
    __syncthreads();
    store_mask_bits(hits, mask + size_t(base));
  }
  store_block_summary(s, warp_sums, stats);
  finish_blocks<false>(stats, totals, scratch, warp_sums);
}

using Kernel = void (*)(const uint8_t*, const MultiTables*, int, int, int, uint8_t*, int*, int*,
                       int*);

#define KREP_MULTI(i) scan_blocks_multi_kernel<((i) & 1) != 0, ((i) & 2) != 0, ((i) & 4) != 0, \
                                               ((i) & 8) != 0>
const Kernel kInstances[16] = {
    KREP_MULTI(0),  KREP_MULTI(1),  KREP_MULTI(2),  KREP_MULTI(3),
    KREP_MULTI(4),  KREP_MULTI(5),  KREP_MULTI(6),  KREP_MULTI(7),
    KREP_MULTI(8),  KREP_MULTI(9),  KREP_MULTI(10), KREP_MULTI(11),
    KREP_MULTI(12), KREP_MULTI(13), KREP_MULTI(14), KREP_MULTI(15),
};
#undef KREP_MULTI

}  // namespace

// Per-block summaries of nblocks * 64 KiB of staged text for the tables at
// `tables` (a device MultiTables), and their fold. `text` must hold
// nblocks * 65536 + 64 readable bytes and be 16-byte aligned; `mask`
// (nullable, 16-byte aligned) receives one 0/1 union byte per text byte;
// `stats` receives 8 int32 per block: matches, first, trail, lead, has_nl,
// 0, 0, 0; `totals` (nullable) the rows folded in text order by the
// launch's last block (matches, matched lines, trail, lead, has_nl, 0, 0,
// 0; `scratch` as for krep_scan_blocks). `prev_word` is the -w flag of the
// byte before the text; with `shard`, starts and the newlines that count
// lie below `start_limit`. Returns the launch's cudaGetLastError().
extern "C" int krep_scan_blocks_multi(const void* text, int nblocks, const void* tables, int icase,
                                      int wword, int true_len, int prev_word, int start_limit,
                                      int shard, void* mask, void* stats, void* totals,
                                      void* scratch, void* stream) {
  if (nblocks < 1 || !tail_ok(nblocks, totals, scratch)) return int(cudaErrorInvalidValue);
  const Kernel kernel =
      kInstances[(icase ? 1 : 0) | (wword ? 2 : 0) | (mask ? 4 : 0) | (shard ? 8 : 0)];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMultiSmem);
  if (err != cudaSuccess) return int(err);
  kernel<<<nblocks, kThreads, kMultiSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const MultiTables*>(tables), true_len,
      prev_word, start_limit, static_cast<uint8_t*>(mask), static_cast<int*>(stats),
      static_cast<int*>(totals), static_cast<int*>(scratch));
  return int(cudaGetLastError());
}
