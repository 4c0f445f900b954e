// Multi-pattern Hamming scan on the int8 tensor cores of NVIDIA Hopper
// (sm_90a), hand-written CUDA C++ with WMMA.
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
// The tables are ops/mxu.py `build_tables`, as in krep_tpu.
//
// What bounds it on the card: the compare of every D element with its row's
// nb (4Kp rows x n/4 words) and the int8 MMAs before it, not bytes moved:
// each text byte is read once, and G (at most 4 x 256 rows x 176 bytes) is
// re-read per tile from L2. The design:
//   * one CUDA block per 64 KiB of staged text, in 64 tiles of 256 words
//     (1 KiB of text). For each tile the block copies the text (and the 64
//     bytes after it) into shared memory, folding -i there, and builds W as
//     0/1 int8 in shared memory: 128 bit rows, 48 boundary rows with -w and
//     128 window-2 rows for a two-window set, stored as 16x16 fragments;
//   * each of the 8 warps takes 16-row tiles of G from global memory (too
//     large for shared memory next to W at K=256) and runs WMMA m16n16k16
//     signed-char products with an int accumulator over the tile's 16
//     column tiles;
//   * the accumulators go to shared memory (the WMMA element layout is
//     opaque), each lane compares 8 of them with their rows' nb, counts the
//     hits and ORs the phase bits of its word into the tile's flags. The
//     flags become the u8 0/1 union mask, in the layout of the scan kernels,
//     so the mask readback and the line kernel take either mask unchanged.
// The -w flag of the byte before a tile is a read of global memory: blocks
// run in no order, so there is no carry like the TPU kernel's SMEM scalar
// (mxu_multi.py:329-347), and boundary features are direct byte tests (not
// the TPU kernel's SWAR borrow, which drops matches after "_^").
// Each block writes its own count: the readback gets per-64 KiB counts.
//
// The shard mode (mxu_multi.py:441-449): on a shard the bytes past its owned
// region are the next shard's text, not zeros, so the staged zero tail no
// longer stops a window there; start_limit drops every start at or past it,
// from the counts and the mask. A tile wholly past the limit is skipped
// (its mask words written as zeros); only the tile that holds the limit
// compares starts. prev_flag is the -w flag of the byte before the text
// (the previous shard's last byte), the before-feature of word 0.
//
// Two more modes are template instances, so the count and mask instances
// compile as before (a run-time mode flag had cost the K=1 scan 18 %):
//   * kLines (`want_lines`, mxu_multi.py:502-528): no mask; the tile's union
//     flags and the newlines of the tile already in shared memory give a
//     line-accounting summary of its 1 KiB (each thread walks its word's 4
//     bytes, the 256 walks fold in order). The TPU kernel carries the line
//     state across its sequential grid in SMEM; here the 64 tiles of a block
//     run in order inside it, so thread 0 folds each tile's summary into the
//     block's, and the block writes 8 stats words (the ALL count, then the
//     union's first, trail, lead, has_nl) that combine_blocks folds across
//     blocks. A flag on a '\n' counts the line it ends, as in lines_scan.cu.
//   * kStrict (`strict`, mxu_multi.py:316-327, :436-447): the bytes past
//     true_len may be live text (a with_len view), so a start of row k counts
//     only when start + len(k) <= true_len (the pattern length rides the
//     rows' fourth word), and -w reads no word flag at or past true_len. Both
//     tests run only in the tiles whose windows reach true_len.
//
// Simple first: no wgmma, TMA or cp.async; a later version moves the
// products to mma.sync / wgmma.

#include <mma.h>

#include "scan_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kTileWords = 256;                                 // W columns per tile
constexpr int kTilesPerBlock = kBlockBytes / (4 * kTileWords);  // 64
constexpr int kWarps = kThreads / 32;
constexpr int kNT = kTileWords / 16;         // column tiles
constexpr int kFrag = 256;                   // bytes of one 16x16 int8 fragment
constexpr int kBoundaryCols = 48;            // -w feature rows (build_tables' BC <= 40)
constexpr int kTileBytes = 4 * kTileWords + kTail;  // windows read up to 36 bytes past a word
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

__host__ __device__ constexpr int smem_bytes(int kt1, int kt2) {
  return (kt1 + kt2) * kNT * kFrag   // W
         + kWarps * 2 * 256 * 4      // per-warp accumulator scratch
         + kTileWords * 4            // per-word phase flags
         + 16 + kTileBytes;          // the byte before the tile, the tile, its tail
}

template <int KT1, int KT2, int M>
__global__ void __launch_bounds__(kThreads)
hamming_scan_kernel(const uint8_t* __restrict__ text, const signed char* __restrict__ g1,
                    const signed char* __restrict__ g2, const int4* __restrict__ rows,
                    int mtiles, int long_tile0, BoundaryOffsets bo, int icase,
                    long long start_limit, int prev_flag, long long true_len,
                    uint8_t* __restrict__ mask, int* __restrict__ out) {
  extern __shared__ __align__(256) uint8_t sm[];
  signed char* w1 = reinterpret_cast<signed char*>(sm);
  signed char* w2 = w1 + KT1 * kNT * kFrag;
  int* scr = reinterpret_cast<int*>(w2 + KT2 * kNT * kFrag);
  uint32_t* wflags = reinterpret_cast<uint32_t*>(scr + kWarps * 512);
  uint8_t* tb = reinterpret_cast<uint8_t*>(wflags + kTileWords) + 16;  // tb[-1]: byte before
  __shared__ int warp_counts[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int* scr1 = scr + warp * 512;
  int* scr2 = scr1 + 256;
  const int col = lane & 15;      // the D column (word) this lane compares
  const int r0 = (lane >> 4) * 8; // ... and its first of 8 rows
  int cnt = 0;
  Summary line = {0, 0, 0, 0, 0};  // kLines: the block's tiles folded so far (thread 0)
  wflags[t] = 0;

  for (int tile = 0; tile < kTilesPerBlock; ++tile) {
    const size_t word0 = size_t(blockIdx.x) * (kBlockBytes / 4) + size_t(tile) * kTileWords;
    const uint8_t* src = text + 4 * word0;
    // block-uniform: all threads skip the same tiles
    if (4 * (long long)word0 >= start_limit) {
      if (mask) reinterpret_cast<uint32_t*>(mask)[word0 + t] = 0;
      continue;
    }
    const bool edge = 4 * (long long)(word0 + kTileWords) > start_limit;
    // kStrict, block-uniform: the tile's windows and -w features reach true_len
    const bool tail = M == kStrict && 4 * (long long)(word0 + kTileWords) + kTail > true_len;

    // 1. The tile's text and tail into shared memory, folded for -i.
    if (t < kTileBytes / 16) {
      uint4 v = reinterpret_cast<const uint4*>(src)[t];
      if (icase) {
        v.x = fold4(v.x);
        v.y = fold4(v.y);
        v.z = fold4(v.z);
        v.w = fold4(v.w);
      }
      reinterpret_cast<uint4*>(tb)[t] = v;
    }
    // only its word-ness is read: 'a' is a word byte, 0 is not
    if (t == 0) tb[-1] = word0 ? src[-1] : (prev_flag ? 'a' : 0);
    __syncthreads();

    // 2. W: column t is word t of the tile. Fragment (kt, nt) holds feature
    //    rows 16kt..16kt+15 of words 16nt..16nt+15, column-major.
    {
      const uint8_t* b = tb + 4 * t;
      const int frag_off = (t >> 4) * kFrag + (t & 15) * 16;
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {  // bit rows: bit r%8 of window byte r/8
        const uint32_t c0 = b[2 * kt], c1 = b[2 * kt + 1];
        *reinterpret_cast<uint4*>(w1 + kt * kNT * kFrag + frag_off) =
            make_uint4(expand4(c0 & 15), expand4(c0 >> 4), expand4(c1 & 15), expand4(c1 >> 4));
      }
      if (KT1 > 8) {  // -w boundary rows
        uint32_t f[kBoundaryCols / 4];
#pragma unroll
        for (int q = 0; q < kBoundaryCols / 4; ++q) {
          uint32_t v = 0;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int o = bo.off[4 * q + jj];
            // kStrict: no word flag at or past true_len
            if (o != kNoByte && (!tail || 4 * (long long)(word0 + t) + o < true_len))
              v |= uint32_t(is_word(b[o])) << (8 * jj);
          }
          f[q] = v;
        }
#pragma unroll
        for (int kt = 8; kt < KT1; ++kt) {
          const int q = 4 * (kt - 8);
          *reinterpret_cast<uint4*>(w1 + kt * kNT * kFrag + frag_off) =
              make_uint4(f[q], f[q + 1], f[q + 2], f[q + 3]);
        }
      }
#pragma unroll
      for (int kt = 0; kt < KT2; ++kt) {  // window-2 bit rows: bytes 16..31
        const uint32_t c0 = b[16 + 2 * kt], c1 = b[17 + 2 * kt];
        *reinterpret_cast<uint4*>(w2 + kt * kNT * kFrag + frag_off) =
            make_uint4(expand4(c0 & 15), expand4(c0 >> 4), expand4(c1 & 15), expand4(c1 >> 4));
      }
    }
    __syncthreads();

    // 3. D = G @ W, one 16-row tile of G per warp at a time.
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a1[KT1];
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a2[KT2 > 0 ? KT2 : 1];
#pragma unroll
      for (int kt = 0; kt < KT1; ++kt)
        wmma::load_matrix_sync(a1[kt], g1 + (size_t(mt) * KT1 + kt) * kFrag, 16);
      const bool two = KT2 > 0 && mt >= long_tile0;
      if (two) {
#pragma unroll
        for (int kt = 0; kt < KT2; ++kt)
          wmma::load_matrix_sync(a2[kt], g2 + (size_t(mt - long_tile0) * KT2 + kt) * kFrag, 16);
      }
      int nb1[8], nb2[8], phase[8], len[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 ri = __ldg(rows + mt * 16 + r0 + i);  // nb1, nb2, phase, pattern length
        nb1[i] = ri.x;
        nb2[i] = ri.y;
        phase[i] = ri.z;
        len[i] = M == kStrict ? ri.w : 0;
      }
      for (int nt = 0; nt < kNT; ++nt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
        wmma::fill_fragment(acc, 0);
#pragma unroll
        for (int kt = 0; kt < KT1; ++kt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, w1 + (kt * kNT + nt) * kFrag, 16);
          wmma::mma_sync(acc, a1[kt], bf, acc);
        }
        wmma::store_matrix_sync(scr1, acc, 16, wmma::mem_row_major);
        if (two) {
          wmma::fill_fragment(acc, 0);
#pragma unroll
          for (int kt = 0; kt < KT2; ++kt) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf;
            wmma::load_matrix_sync(bf, w2 + (kt * kNT + nt) * kFrag, 16);
            wmma::mma_sync(acc, a2[kt], bf, acc);
          }
          wmma::store_matrix_sync(scr2, acc, 16, wmma::mem_row_major);
        }
        __syncwarp();
        uint32_t bits = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          int hit = scr1[(r0 + i) * 16 + col] == nb1[i];
          if (two) hit &= scr2[(r0 + i) * 16 + col] == nb2[i];
          if (edge) hit &= 4 * (long long)(word0 + nt * 16 + col) + phase[i] < start_limit;
          if (M == kStrict && tail)
            hit &= 4 * (long long)(word0 + nt * 16 + col) + phase[i] + len[i] <= true_len;
          cnt += hit;
          bits |= uint32_t(hit) << phase[i];
        }
        bits |= __shfl_xor_sync(0xffffffffu, bits, 16);
        if (lane < 16 && bits) atomicOr(&wflags[nt * 16 + col], bits);
        __syncwarp();
      }
    }
    __syncthreads();

    // 4. The tile's union mask: byte 4w+p is 1 when a pattern starts there;
    //    kLines: instead the line summary of the tile's 1 KiB, in byte
    //    order (thread t walks word t), folded into the block's by thread 0.
    if constexpr (M == kLines) {
      __shared__ Summary warp_sums[kWarps];
      const uint32_t flags = wflags[t];
      const uint32_t bytes = reinterpret_cast<const uint32_t*>(tb)[t];  // folding keeps '\n'
      Summary s = {0, 0, 0, 0, 0};
      int state = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        walk_step(s, state, int((flags >> j) & 1), int(((bytes >> (8 * j)) & 0xFF) == '\n'));
      s.trail = state;
      s = warp_fold(s);
      if (lane == 0) warp_sums[warp] = s;
      __syncthreads();  // the next write of warp_sums follows two more barriers
      if (t == 0) {
        for (int w = 0; w < kWarps; ++w) line = combine(line, warp_sums[w]);
      }
    } else if (mask) {
      reinterpret_cast<uint32_t*>(mask)[word0 + t] = expand4(wflags[t]);
    }
    wflags[t] = 0;  // the next tile's first barrier orders this before its atomics
  }

  // 5. The block's match count (kLines: and the union's line summary).
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) warp_counts[warp] = cnt;
  __syncthreads();
  if (t == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_counts[w];
    if constexpr (M == kLines) {
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

template <int KT1, int KT2, int M>
int launch(const void* text, int nblocks, const void* g1, const void* g2, const void* rows,
           int mtiles, int long_tile0, const BoundaryOffsets& bo, int icase,
           long long start_limit, int prev_flag, long long true_len, void* mask, void* out,
           void* stream) {
  constexpr int smem = smem_bytes(KT1, KT2);
  cudaError_t err = cudaFuncSetAttribute(hamming_scan_kernel<KT1, KT2, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  hamming_scan_kernel<KT1, KT2, M><<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const signed char*>(g1),
      static_cast<const signed char*>(g2), static_cast<const int4*>(rows), mtiles, long_tile0,
      bo, icase, start_limit, prev_flag, true_len, static_cast<uint8_t*>(mask),
      static_cast<int*>(out));
  return int(cudaGetLastError());
}

template <int M>
int launch_mode(const void* text, int nblocks, const void* g1, const void* g2, const void* rows,
                int mtiles, int long_tile0, const signed char* boundary, int icase,
                long long start_limit, int prev_flag, long long true_len, void* mask, void* out,
                void* stream) {
  BoundaryOffsets bo;
  for (int c = 0; c < kBoundaryCols; ++c) bo.off[c] = boundary ? boundary[c] : kNoByte;
  const bool two = g2 != nullptr && long_tile0 < mtiles;
  if (boundary)
    return two ? launch<11, 8, M>(text, nblocks, g1, g2, rows, mtiles, long_tile0, bo, icase,
                                  start_limit, prev_flag, true_len, mask, out, stream)
               : launch<11, 0, M>(text, nblocks, g1, g2, rows, mtiles, mtiles, bo, icase,
                                  start_limit, prev_flag, true_len, mask, out, stream);
  return two ? launch<8, 8, M>(text, nblocks, g1, g2, rows, mtiles, long_tile0, bo, icase,
                               start_limit, prev_flag, true_len, mask, out, stream)
             : launch<8, 0, M>(text, nblocks, g1, g2, rows, mtiles, mtiles, bo, icase,
                               start_limit, prev_flag, true_len, mask, out, stream);
}

}  // namespace

// Match counts per 64 KiB block (`out`, nblocks int32) and the 0/1 union
// start mask (`mask`, nullable, nblocks * 65536 bytes) of nblocks * 64 KiB of
// staged text, which must be 16-byte aligned and hold 64 more readable bytes.
// g1: mtiles x (8, or 11 with `boundary`) int8 16x16 fragments, row-major;
// g2: (mtiles - long_tile0) x 8 fragments (null for a one-window set);
// rows: mtiles * 16 int4 of (nb1, nb2, phase, pattern length); boundary:
// null, or the 48 byte offsets of the -w feature rows. Only starts below
// `start_limit` count; `prev_flag` is the -w flag of the byte before the
// text. `mode` 1 (lines) writes 8 int32 stats per block to `out` instead:
// the count, then the union's first, trail, lead, has_nl, 0, 0, 0; it takes
// no mask and no start_limit. `mode` 2 (strict) counts a start of a pattern
// of length m only where start + m <= `true_len`, and reads no -w flag at or
// past it. Returns the launch's cudaGetLastError().
extern "C" int krep_hamming_scan(const void* text, int nblocks, const void* g1, const void* g2,
                                 const void* rows, int mtiles, int long_tile0,
                                 const signed char* boundary, int icase, long long start_limit,
                                 int prev_flag, long long true_len, int mode, void* mask,
                                 void* out, void* stream) {
  if (nblocks < 1 || mtiles < 1 || long_tile0 < 0 || long_tile0 > mtiles || start_limit < 0 ||
      true_len < 0 || mode < kCount || mode > kStrict)
    return int(cudaErrorInvalidValue);
  if (mode == kLines && mask) return int(cudaErrorInvalidValue);
  if (mode == kLines)
    return launch_mode<kLines>(text, nblocks, g1, g2, rows, mtiles, long_tile0, boundary, icase,
                               start_limit, prev_flag, true_len, mask, out, stream);
  if (mode == kStrict)
    return launch_mode<kStrict>(text, nblocks, g1, g2, rows, mtiles, long_tile0, boundary, icase,
                                start_limit, prev_flag, true_len, mask, out, stream);
  return launch_mode<kCount>(text, nblocks, g1, g2, rows, mtiles, long_tile0, boundary, icase,
                             start_limit, prev_flag, true_len, mask, out, stream);
}
