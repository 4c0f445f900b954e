// Multi-pattern Hamming scan on the int8 tensor cores of NVIDIA Hopper
// (sm_90a), hand-written CUDA C++ with inline-PTX mma.sync m16n8k32.
//
// Replaces the TPU kernel krep_tpu/ops/mxu_multi.py `_make_kernel` (built at
// :209, pallas_call at :722 in `scan_count` :559) in all its modes: the count
// and the union mask, with and without start_limit and prev_flag (the
// per-shard count of parallel/mesh.py), the in-kernel line count
// (`want_lines`) and the explicit start bound (`strict`). The formulation is
// the TPU kernel's: a match of pattern k at byte 4w+p (word w, phase p) is a
// Hamming distance of zero between the pattern and the bits of the window
// at word w, and with the text's bits as features W[(j,b), w] = bit b of
// byte 4w+j and weights G[(p,k), (j,b)] = 1 - 2 * pattern bit, the distance
// is linear in W:
//     D = G @ W,   match  <=>  D[(p,k), w] == nb[(p,k)] = -(set bits of k)
// Rows of patterns over 13 bytes need a second window (bytes 16..31, G2)
// and hit only where both products hit (the two-window AND). -w appends
// boundary features (is-word of the byte before the match and of the byte
// after it) that add a non-negative violation to the same product.
// The tables are ops/mxu.py `build_tables`, as in krep_tpu; `device_tables`
// lays G out for this kernel.
//
// What bounds it on the card: the int8 products (2 x 4Kp rows x 128 [+64]
// features x n/4 words: 8.9 ms of 1,979 TOP/s for the 64 variants of 1 GiB)
// and the compare of every D element with its row's nb (the same count of
// elements, one instruction each), not bytes: each text byte is read once.
// Measured on an H100 (PERF.md): with the compare removed the 64 variants
// take 19.5 ms of 26 at 1 GiB, about 8 SM clocks per mma.sync m16n8k32,
// half the wgmma rate the 8.9 ms assumes; wgmma is the next step.
// The first design (WMMA m16n16k16) spent most of its time in shared memory:
// every warp re-read the tile's W for each 16-row tile of G, and every
// accumulator went through shared memory because WMMA's element layout is
// opaque. This design:
//   * one CUDA block per 64 KiB of staged text, in 64 tiles of 256 words
//     (1 KiB of text). The text of the next tile (and the 16 bytes before
//     it, the 64 after it) streams into shared memory with cp.async while
//     the block computes on the current one (two buffers);
//   * G is copied into shared memory once per block, in the lane order of
//     mma.sync's A fragment (device_tables lays it out so), so a lane's
//     fragment of a 16x32 tile of G is one 16-byte shared load: what
//     ldmatrix.x4 would hand it, without the address arithmetic. A pass
//     whose G does not fit next to the text (kGBudget: the 256-pattern
//     passes) reads the same fragments from global memory (L1/L2) instead,
//     one coalesced 512-byte load per warp and fragment;
//   * each warp owns 32 words of the tile (four n8 column tiles) and builds
//     their B fragments in registers, once per tile, straight from the text
//     words: the B fragment of m16n8k32 gives a lane the features
//     32ks + 4t..4t+3 and 32ks + 16 + 4t..4t+3 of word 8n + g (g = lane/4,
//     t = lane%4), which are the nibbles at bit 4t and 4t + 16 of text word
//     w + ks, spread to bytes by expand4. W is never stored. The warp then
//     walks every 16-row tile of G: one A fragment load feeds four mma
//     (128 bytes of shared memory per 8,192-operation mma);
//   * the accumulators stay in registers: the C fragment's layout is
//     documented (a lane holds rows g and g+8 at columns 2t and 2t+1), so a
//     lane compares its four elements with its two rows' nb into a 16-bit
//     hit mask. Hits need not be rare (bench.py's sets match every 6 bytes
//     of its corpus), and a branch on them cost 20-120 % on an H100 (PERF.md),
//     so the loop has none: every 8-row group of rows is of one phase
//     (device_tables), the phases are two warp-uniform shared-memory
//     reads, the count is a popc, and the word flags take the hit mask's
//     bit positions, so a group's hits OR into them with one shift. Only
//     the tiles that hold start_limit or reach true_len (kStrict) run an
//     instance of the loop that tests each hit's start;
//   * the second window (long rows) runs only for a 16-row tile whose first
//     window hit somewhere in the warp's 32 words: its B fragments are built
//     then, from words w+4..w+7, and are never held;
//   * the union flags of a word are an OR over the 8 lanes that share its
//     columns (three shuffles); a warp writes its 32 mask words in one
//     coalesced store, and in kLines walks them in order, with no atomics.
// -w's boundary features are direct byte tests (not the TPU kernel's SWAR
// borrow, which drops matches after "_^"); the byte before the text is
// prev_flag. Blocks run in no order, so there is no carry like the TPU
// kernel's SMEM scalar (mxu_multi.py:329-347): the byte before a tile rides
// its copy. Each block writes its own count: the readback gets per-64 KiB
// counts.
//
// The shard mode (mxu_multi.py:441-449): on a shard the bytes past its owned
// region are the next shard's text, not zeros, so the staged zero tail no
// longer stops a window there; start_limit drops every start at or past it,
// from the counts and the mask. Tiles wholly past the limit are skipped
// (their mask words written as zeros); only the tile that holds the limit
// tests starts. prev_flag is the -w flag of the byte before the text.
//
// Modes are template instances (a run-time mode flag had cost the K=1 scan
// 18 %):
//   * kLines (`want_lines`, mxu_multi.py:502-528): no mask; each thread
//     walks the 4 bytes of its word with the word's union flags, and each
//     warp folds its lanes' summaries in order into shared memory (the TPU
//     kernel carries the line state across its sequential grid in SMEM;
//     here the block keeps its 64 tiles x 8 warp summaries, 10 KiB, and
//     folds them in order at its end, in parallel: a fold by one thread
//     after every tile cost the first version 17 % over the count). The
//     block writes 8 stats words (the ALL count, then the union's
//     first, trail, lead, has_nl) that combine_blocks folds across blocks.
//     A flag on a '\n' counts the line it ends, as in lines_scan.cu.
//   * kStrict (`strict`, mxu_multi.py:316-327, :436-447): the bytes past
//     true_len may be live text (a with_len view), so a start of row k counts
//     only when start + len(k) <= true_len, and -w reads no word flag at or
//     past true_len. Both tests run only in the tiles whose windows reach
//     true_len, and a row's length is read from global memory only in the
//     bounded instance of the row loop those tiles run, where the compiler
//     cannot hoist it into the common loop (a hoisted length load made a
//     strict instance twice as slow as the count).

#include "scan_common.cuh"

namespace {

constexpr int kTileWords = 256;                                 // words per tile
constexpr int kTilesPerBlock = kBlockBytes / (4 * kTileWords);  // 64
constexpr int kWarps = kThreads / 32;
constexpr int kWarpWords = kTileWords / kWarps;  // 32 words: four n8 column tiles
constexpr int kN8 = kWarpWords / 8;
constexpr int kFragBytes = 512;  // one 16x32 int8 A fragment, 16 bytes per lane
constexpr int kBoundaryCols = 48;  // -w feature rows (build_tables' BC <= 40)
constexpr int kBefore = 16;        // bytes copied before a tile (the -w before-byte)
constexpr int kBufBytes = kBefore + 4 * kTileWords + kTail;  // 1,104: 69 chunks of 16
constexpr int kGBudget = 96 * 1024;  // G and its nb in shared memory up to this
constexpr int kMaxTiles = 66;        // 16-row tiles of a 256-pattern pass: 4 x (256 + 8) rows
constexpr int kNoByte = -128;

enum Mode { kCount = 0, kLines = 1, kStrict = 2 };  // kCount also writes the mask

// Byte offset, relative to a word's first byte, whose is-word flag feeds
// each -w feature row (kNoByte: a zero row).
struct BoundaryOffsets {
  signed char off[kBoundaryCols];
};

// Bits 0..3 of nib as the bytes 0/1 of a word (no carries between terms).
__device__ __forceinline__ uint32_t expand4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// A lane's hits among its 4 x 4 accumulators, element (n, e) at bit 4n + e
// in the C fragment's order: bit 1 of e picks row g + 8 over row g, bit 0
// column 2tq + 1 over 2tq; lo and hi are the nb of rows g and g + 8.
__device__ __forceinline__ uint32_t hit_mask(const int (&acc)[kN8][4], int lo, int hi) {
  uint32_t h = 0;
#pragma unroll
  for (int n = 0; n < kN8; ++n)
    h |= (uint32_t(acc[n][0] == lo) | uint32_t(acc[n][1] == lo) << 1 |
          uint32_t(acc[n][2] == hi) << 2 | uint32_t(acc[n][3] == hi) << 3) << (4 * n);
  return h;
}

// A compile-time flag for a generic lambda's instances.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Where phase p of a word sits in a lane's flags: 0, 2, 16, 18 bits above
// the word's position, beside the hit mask's positions 4n + c.
__device__ __forceinline__ int pshift(int p) { return ((p & 1) << 1) | ((p & 2) << 3); }

// d += a (16x32, row) x b (32x8, col), s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// The is-word flags of the 4 bytes at offsets `offs` (4 signed bytes) from
// tile byte 4w, as the bytes 0/1 of a word; kStrict's tail: none at or past
// true_len.
template <int M>
__device__ __forceinline__ uint32_t boundary_feature(const uint8_t* tb, int w, uint32_t offs,
                                                     bool tail, long long word_g,
                                                     long long true_len) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = static_cast<signed char>(offs >> (8 * i));
    if (o != kNoByte && (M != kStrict || !tail || 4 * word_g + o < true_len))
      v |= uint32_t(is_word(tb[4 * w + o])) << (8 * i);
  }
  return v;
}

// Dynamic shared memory of an instance: G1, G2 and their rows' nb (when
// GS), then the two text buffers.
__host__ __device__ constexpr int g_bytes(int ks1, bool two, int mtiles, int long_tile0) {
  return mtiles * ks1 * kFragBytes + (two ? (mtiles - long_tile0) * 4 * kFragBytes : 0)
         + 16 * mtiles * 8;
}

// Three blocks per SM (80 registers) where the B fragments leave room: the
// instances without -w; the -w instances hold 44 B registers and keep two.
template <int KS1, bool TWO, int M, bool GS>
__global__ void __launch_bounds__(kThreads, KS1 == 4 ? 3 : 2)
hamming_scan_kernel(const uint8_t* __restrict__ text, const uint4* __restrict__ g1,
                    const uint4* __restrict__ g2, const int4* __restrict__ rows, int mtiles,
                    int long_tile0, BoundaryOffsets bo, int icase, long long start_limit,
                    int prev_flag, long long true_len, uint8_t* __restrict__ mask,
                    int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ uint32_t bo_s[kBoundaryCols / 4];
  __shared__ int ph_s[2 * kMaxTiles];  // the phase of each 8-row group
  __shared__ int warp_counts[kWarps];
  __shared__ Summary warp_sums[kWarps];
  // kLines: each tile's 8 warp summaries, folded in order at the block's end
  __shared__ Summary tile_sums[M == kLines ? kTilesPerBlock * kWarps : 1];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;  // the fragment's group: B column, C rows g and g+8
  const int tq = lane & 3;  // thread in group: B features, C columns 2tq, 2tq+1
  const int wbase = warp * kWarpWords;

  const uint4* a1 = g1;
  const uint4* a2 = g2;
  const int2* nbs = nullptr;  // (nb1, nb2) of each row, in shared memory (GS)
  uint8_t* tbuf = sm;
  if constexpr (GS) {
    const int n1 = mtiles * KS1 * (kFragBytes / 16);
    const int n2 = TWO ? (mtiles - long_tile0) * 4 * (kFragBytes / 16) : 0;
    uint4* s1 = reinterpret_cast<uint4*>(sm);
    uint4* s2 = s1 + n1;
    int2* snb = reinterpret_cast<int2*>(s2 + n2);
    for (int i = t; i < n1; i += kThreads) cp_async16(s1 + i, g1 + i, 16);
    for (int i = t; i < n2; i += kThreads) cp_async16(s2 + i, g2 + i, 16);
    for (int r = t; r < 16 * mtiles; r += kThreads) {
      const int4 ri = __ldg(rows + r);
      snb[r] = make_int2(ri.x, ri.y);
    }
    a1 = s1;
    a2 = s2;
    nbs = snb;
    tbuf = reinterpret_cast<uint8_t*>(snb + 16 * mtiles);
  }
  for (int i = t; i < 2 * mtiles; i += kThreads) ph_s[i] = __ldg(&rows[8 * i].z);
  if (t < kBoundaryCols / 4) {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= uint32_t(uint8_t(bo.off[4 * t + i])) << (8 * i);
    bo_s[t] = v;
  }

  // Tiles wholly past start_limit compare nothing (block-uniform).
  const long long block_byte = (long long)blockIdx.x * kBlockBytes;
  const int ntiles = start_limit <= block_byte ? 0
                     : (int)min((long long)kTilesPerBlock,
                                (start_limit - block_byte + 4 * kTileWords - 1) / (4 * kTileWords));
  const size_t block_word = size_t(blockIdx.x) * (kBlockBytes / 4);

  auto issue_tile = [&](int tile) {
    const size_t word0 = block_word + size_t(tile) * kTileWords;
    uint8_t* buf = tbuf + (tile & 1) * kBufBytes;
    if (t < kBufBytes / 16) {
      const bool none = word0 == 0 && t == 0;  // nothing before the text: zeros
      cp_async16(buf + 16 * t, none ? text : text + 4 * word0 - kBefore + 16 * t, none ? 0 : 16);
    }
  };

  int cnt = 0;
  if (ntiles > 0) issue_tile(0);
  cp_async_commit();  // G (GS) and tile 0

  for (int tile = 0; tile < ntiles; ++tile) {
    const size_t word0 = block_word + size_t(tile) * kTileWords;
    if (tile + 1 < ntiles) issue_tile(tile + 1);
    cp_async_commit();
    cp_async_wait1();
    uint8_t* tb = tbuf + (tile & 1) * kBufBytes + kBefore;  // tb[-1]: the byte before
    // only its word-ness is read: 'a' is a word byte, 0 is not
    if (word0 == 0 && t == 0 && prev_flag) tb[-1] = 'a';
    __syncthreads();

    const uint32_t* tbw = reinterpret_cast<const uint32_t*>(tb);
    const bool edge = 4 * (long long)(word0 + kTileWords) > start_limit;
    // kStrict, block-uniform: the tile's windows and -w features reach true_len
    const bool tail = M == kStrict && 4 * (long long)(word0 + kTileWords) + kTail > true_len;

    // 1. The B fragments of the warp's four n8 column tiles, in registers.
    uint32_t b[kN8][KS1][2];
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      const int w = wbase + 8 * n + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // bit rows: window bytes 4ks..4ks+3
        uint32_t x = tbw[w + ks];
        if (icase) x = fold4(x);
        b[n][ks][0] = expand4((x >> (4 * tq)) & 15);
        b[n][ks][1] = expand4((x >> (4 * tq + 16)) & 15);
      }
      if constexpr (KS1 == 6) {  // -w boundary rows: feature groups tq, 4+tq, 8+tq
        const long long wg = (long long)(word0 + w);
        b[n][4][0] = boundary_feature<M>(tb, w, bo_s[tq], tail, wg, true_len);
        b[n][4][1] = boundary_feature<M>(tb, w, bo_s[4 + tq], tail, wg, true_len);
        b[n][5][0] = boundary_feature<M>(tb, w, bo_s[8 + tq], tail, wg, true_len);
        b[n][5][1] = 0;  // features 48..63: zero columns of G
      }
    }

    // 2. D = G @ W over every 16-row tile of G; compare in registers. A
    //    lane's hits are a 16-bit mask, element (n, e) at bit 4n + e (e: row
    //    g or g+8 times 2, plus the column 2tq + c); the flags of its 8
    //    words take the same positions, phase p of word (n, c) at bit
    //    4n + c + pshift(p), so a row group's hits OR in with one shift.
    //    The tiles that hold start_limit or reach true_len (block-uniform)
    //    run their own instance of the loop, which tests each hit's start:
    //    the common loop has no branch past the compare.
    uint32_t fl = 0;
    auto scan_rows = [&](auto bounded) {
      constexpr bool kBounded = decltype(bounded)::value;
      for (int mt = 0; mt < mtiles; ++mt) {
        int acc[kN8][4];
#pragma unroll
        for (int n = 0; n < kN8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
          const int f = (mt * KS1 + ks) * 32 + lane;
          const uint4 a = GS ? a1[f] : __ldg(a1 + f);
#pragma unroll
          for (int n = 0; n < kN8; ++n) mma_s8(acc[n], a, b[n][ks][0], b[n][ks][1]);
        }
        const int r_lo = 16 * mt + g;
        const int2 nlo = GS ? nbs[r_lo] : make_int2(__ldg(&rows[r_lo].x), __ldg(&rows[r_lo].y));
        const int2 nhi =
            GS ? nbs[r_lo + 8] : make_int2(__ldg(&rows[r_lo + 8].x), __ldg(&rows[r_lo + 8].y));
        uint32_t h = hit_mask(acc, nlo.x, nhi.x);
        // the second window, only where the warp's first window hit
        if (TWO && mt >= long_tile0 && __any_sync(0xffffffffu, h)) {
#pragma unroll
          for (int n = 0; n < kN8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int f = ((mt - long_tile0) * 4 + ks) * 32 + lane;
            const uint4 a = GS ? a2[f] : __ldg(a2 + f);
#pragma unroll
            for (int n = 0; n < kN8; ++n) {
              uint32_t x = tbw[wbase + 8 * n + g + 4 + ks];  // window bytes 16 + 4ks..
              if (icase) x = fold4(x);
              mma_s8(acc[n], a, expand4((x >> (4 * tq)) & 15), expand4((x >> (4 * tq + 16)) & 15));
            }
          }
          h &= hit_mask(acc, nlo.y, nhi.y);
        }
        const int p_lo = ph_s[2 * mt], p_hi = ph_s[2 * mt + 1];  // warp-uniform
        if constexpr (!kBounded) {
          cnt += __popc(h);
          fl |= (h & 0x3333u) << pshift(p_lo) | ((h >> 2) & 0x3333u) << pshift(p_hi);
        } else {
          while (h) {
            const int e = __ffs(h) - 1;
            h &= h - 1;
            const int n = e >> 2, c = e & 1, hi = (e >> 1) & 1;
            const int ph = hi ? p_hi : p_lo;
            const long long start = 4 * (long long)(word0 + wbase + 8 * n + 2 * tq + c) + ph;
            bool ok = start < start_limit;
            if (M == kStrict && tail) ok = ok && start + __ldg(&rows[r_lo + 8 * hi].w) <= true_len;
            if (ok) {
              ++cnt;
              fl |= 1u << (4 * n + c + pshift(ph));
            }
          }
        }
      }
    };
    if (edge || (M == kStrict && tail))
      scan_rows(Flag<true>{});
    else
      scan_rows(Flag<false>{});

    // 3. The union flags of each of the warp's words: an OR over the 8 lanes
    //    that share its columns; lane L then takes word wbase + L, which is
    //    word (L / 8, L % 2) of lane (L / 2) % 4.
    fl |= __shfl_xor_sync(0xffffffffu, fl, 4);
    fl |= __shfl_xor_sync(0xffffffffu, fl, 8);
    fl |= __shfl_xor_sync(0xffffffffu, fl, 16);
    const uint32_t x =
        __shfl_sync(0xffffffffu, fl, (lane >> 1) & 3) >> (4 * (lane >> 3) + (lane & 1));
    const uint32_t nib = (x & 1) | ((x >> 1) & 2) | ((x >> 14) & 4) | ((x >> 15) & 8);

    // 4. The tile's union mask: byte 4w+p is 1 when a pattern starts there;
    //    kLines: instead the line summaries of the tile's words, in byte
    //    order (thread t walks word t), one per warp, kept for the block's end.
    if constexpr (M == kLines) {
      const uint32_t bytes = tbw[t];  // unfolded: '\n' as it is
      Summary s = {0, 0, 0, 0, 0};
      int state = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        walk_step(s, state, int((nib >> j) & 1), int(((bytes >> (8 * j)) & 0xFF) == '\n'));
      s.trail = state;
      s = warp_fold(s);
      if (lane == 0) tile_sums[tile * kWarps + warp] = s;
    } else if (mask) {
      reinterpret_cast<uint32_t*>(mask)[word0 + t] = expand4(nib);
    }
    __syncthreads();  // the next tile's copy overwrites this buffer
  }
  asm volatile("cp.async.wait_all;\n" ::);  // a block with no live tile issued G's copy
  if (mask) {
    for (int tile = ntiles; tile < kTilesPerBlock; ++tile)
      reinterpret_cast<uint32_t*>(mask)[block_word + size_t(tile) * kTileWords + t] = 0;
  }

  // 5. The block's match count (kLines: and the union's line summary, the
  //    512 tile summaries folded in order: two per thread, then the warps).
  if constexpr (M == kLines) {
    const Summary s = warp_fold(combine(tile_sums[2 * t], tile_sums[2 * t + 1]));
    if (lane == 0) warp_sums[warp] = s;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) warp_counts[warp] = cnt;
  __syncthreads();
  if (t == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_counts[w];
    if constexpr (M == kLines) {
      Summary line = warp_sums[0];
      for (int w = 1; w < kWarps; ++w) line = combine(line, warp_sums[w]);
      int* row = out + blockIdx.x * kStatWords;
      row[0] = s;
      row[1] = line.first;
      row[2] = line.trail;
      row[3] = line.lead;
      row[4] = line.has_nl;
      row[5] = row[6] = row[7] = 0;
    } else {
      out[blockIdx.x] = s;
    }
  }
}

template <int KS1, bool TWO, int M, bool GS>
int launch(const void* text, int nblocks, const void* g1, const void* g2, const void* rows,
           int mtiles, int long_tile0, const BoundaryOffsets& bo, int icase,
           long long start_limit, int prev_flag, long long true_len, void* mask, void* out,
           void* stream) {
  const int smem = (GS ? g_bytes(KS1, TWO, mtiles, long_tile0) : 0) + 2 * kBufBytes;
  cudaError_t err = cudaFuncSetAttribute(hamming_scan_kernel<KS1, TWO, M, GS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const auto st = static_cast<cudaStream_t>(stream);
  hamming_scan_kernel<KS1, TWO, M, GS><<<nblocks, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(text), static_cast<const uint4*>(g1),
      static_cast<const uint4*>(g2), static_cast<const int4*>(rows), mtiles, long_tile0, bo,
      icase, start_limit, prev_flag, true_len, static_cast<uint8_t*>(mask),
      static_cast<int*>(out));
  return int(cudaGetLastError());
}

template <int KS1, bool TWO, int M>
int launch_g(bool gs, const void* text, int nblocks, const void* g1, const void* g2,
             const void* rows, int mtiles, int long_tile0, const BoundaryOffsets& bo, int icase,
             long long start_limit, int prev_flag, long long true_len, void* mask, void* out,
             void* stream) {
  return gs ? launch<KS1, TWO, M, true>(text, nblocks, g1, g2, rows, mtiles, long_tile0, bo, icase,
                                        start_limit, prev_flag, true_len, mask, out, stream)
            : launch<KS1, TWO, M, false>(text, nblocks, g1, g2, rows, mtiles, long_tile0, bo,
                                         icase, start_limit, prev_flag, true_len, mask, out,
                                         stream);
}

template <int M>
int launch_mode(const void* text, int nblocks, const void* g1, const void* g2, const void* rows,
                int mtiles, int long_tile0, const signed char* boundary, int icase,
                long long start_limit, int prev_flag, long long true_len, void* mask, void* out,
                void* stream) {
  BoundaryOffsets bo;
  for (int c = 0; c < kBoundaryCols; ++c) bo.off[c] = boundary ? boundary[c] : kNoByte;
  const bool two = g2 != nullptr && long_tile0 < mtiles;
  const int lt0 = two ? long_tile0 : mtiles;
  const bool gs = g_bytes(boundary ? 6 : 4, two, mtiles, lt0) <= kGBudget;
  if (boundary)
    return two ? launch_g<6, true, M>(gs, text, nblocks, g1, g2, rows, mtiles, lt0, bo, icase,
                                      start_limit, prev_flag, true_len, mask, out, stream)
               : launch_g<6, false, M>(gs, text, nblocks, g1, g2, rows, mtiles, lt0, bo, icase,
                                       start_limit, prev_flag, true_len, mask, out, stream);
  return two ? launch_g<4, true, M>(gs, text, nblocks, g1, g2, rows, mtiles, lt0, bo, icase,
                                    start_limit, prev_flag, true_len, mask, out, stream)
             : launch_g<4, false, M>(gs, text, nblocks, g1, g2, rows, mtiles, lt0, bo, icase,
                                     start_limit, prev_flag, true_len, mask, out, stream);
}

}  // namespace

// Match counts per 64 KiB block (`out`, nblocks int32) and the 0/1 union
// start mask (`mask`, nullable, nblocks * 65536 bytes) of nblocks * 64 KiB of
// staged text, which must be 16-byte aligned and hold 64 more readable bytes.
// g1: mtiles x (4, or 6 with `boundary`) A fragments of m16n8k32, 512 bytes
// each in lane order (ops/mxu.py `_fragments`); g2: (mtiles - long_tile0) x 4
// fragments (null for a one-window set); rows: mtiles * 16 int4 of (nb1, nb2,
// phase, pattern length); boundary: null, or the 48 byte offsets of the -w
// feature rows. Only starts below `start_limit` count; `prev_flag` is the -w
// flag of the byte before the text. `mode` 1 (lines) writes 8 int32 stats
// per block to `out` instead: the count, then the union's first, trail, lead,
// has_nl, 0, 0, 0; it takes no mask and no start_limit. `mode` 2 (strict)
// counts a start of a pattern of length m only where start + m <=
// `true_len`, and reads no -w flag at or past it. Returns the launch's
// cudaGetLastError().
extern "C" int krep_hamming_scan(const void* text, int nblocks, const void* g1, const void* g2,
                                 const void* rows, int mtiles, int long_tile0,
                                 const signed char* boundary, int icase, long long start_limit,
                                 int prev_flag, long long true_len, int mode, void* mask,
                                 void* out, void* stream) {
  if (nblocks < 1 || mtiles < 1 || mtiles > kMaxTiles || long_tile0 < 0 ||
      long_tile0 > mtiles || start_limit < 0 || true_len < 0 || mode < kCount || mode > kStrict)
    return int(cudaErrorInvalidValue);
  if (mode == kLines && (mask || start_limit < (long long)nblocks * kBlockBytes))
    return int(cudaErrorInvalidValue);  // every tile's summary is folded
  if (mode == kLines)
    return launch_mode<kLines>(text, nblocks, g1, g2, rows, mtiles, long_tile0, boundary, icase,
                               start_limit, prev_flag, true_len, mask, out, stream);
  if (mode == kStrict)
    return launch_mode<kStrict>(text, nblocks, g1, g2, rows, mtiles, long_tile0, boundary, icase,
                                start_limit, prev_flag, true_len, mask, out, stream);
  return launch_mode<kCount>(text, nblocks, g1, g2, rows, mtiles, long_tile0, boundary, icase,
                             start_limit, prev_flag, true_len, mask, out, stream);
}
