// The dense-DFA walk of KREP_TPU_DFA=1 (large pattern sets through one
// Aho-Corasick automaton), for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces krep_tpu/ops/ac.py `dfa_scan` (:85-116), a jax.lax.scan that
// steps L lanes of a copied (L, T) lane array together, one gather
// `state = table[state, byte]` per step. Here the kernel reads the staged
// text in place: thread t owns the span [t * span, (t + 1) * span) of the
// body (span chosen by the wrapper; the result does not depend on it). It first steps through the `halo` =
// maxlen - 1 bytes before its span without emitting (bytes before the text
// read as zero, as the lane array's zero prefix does), which leaves it in
// the state a walk from the text's start would have, since an automaton
// state is the longest pattern prefix that ends there and is at most maxlen
// bytes long. It then steps through its span, 16 bytes from one uint4 load
// at a time (the next one already in flight), adds each position's
// emissions below n to a per-thread sum, and in the mask instances flags
// the positions with an emission (a match's last byte), zeros past n, over
// the whole body. A warp reduction and one 64-bit atomicAdd per block give
// the total.
//
// What bounds it on the card: the throughput of the table gathers, one per
// byte, not the bytes (n read and, with the mask, n written: 0.32 / 0.64 ms
// per GiB at 3.35 TB/s) and not the latency of each thread's chain of
// dependent loads (2^18 threads in flight hide it). The first design made
// two dependent gathers per byte through L1 (`table[state * 256 + b]`, then
// `emit[state]`), 32 distinct lines per warp load: 1.72 ms per GiB counting;
// its mask instance stored 16 flags a thread with the lanes of a warp a span
// apart (4 KiB at 1 GiB), 32 lines per warp store: 6.14 ms; -i folded every
// byte; spans of at least 256 B left 16 MiB with 2^16 threads, a quarter of
// the card (PERF.md). This design:
//   * one gather per byte: each entry of the packed table (ops/ac.py
//     pack_dense_table) holds the next state and that state's emission
//     count or flag, so the count and the mask need no second load;
//   * -i lives in the table: column b holds the entry of column fold(b), so
//     the walk consumes raw bytes (fold(0) = 0 keeps the zero prefix);
//   * small automata (kSharedTable, at most kSharedMaxStates states) keep
//     the table in shared memory as 16-bit entries: the row of state s
//     starts at entry R(s) = 258 s + flag(s) (flag: s emits), and an entry
//     is R(next), so the step is `e = table[e + b]`, the flag is e & 1 and
//     a flagged state's count sits in the row's pad slot R(s) - 1, read
//     under a predicate. The stride of 258 entries (129 words) skews row s
//     by s banks, so lanes in different states reading the same byte do not
//     meet in one bank; lanes in one state share the word. Blocks of 1,024
//     threads, two per SM;
//   * larger automata (kGlobalTable, up to 65,536 states) keep 32-bit
//     entries in device memory, L2-resident for the sets the route takes
//     (the 65,536-state cap is 64 MiB): low 16 bits the next state, high 16
//     its emission count, read through L1. A set whose counts pass 16 bits
//     (duplicates in a -f list) takes kWideTable: the same entries, high 16
//     bits the count clamped to 0xFFFF, and its exact count from emit[],
//     read only where the entry flags an emission;
//   * mask stores a warp coalesces: each thread keeps 16 flag bits per 16
//     bytes in shared memory, 128 bits per 128 bytes of its span; then each
//     warp writes its 32 threads' runs as 0/1 bytes, lane l the 4 bytes of
//     nibble l of a run, so every store is one whole 128-byte line (spans
//     under 128 B: the warp's 32 runs are contiguous, written the same way);
//   * the wrapper sizes the spans so that one launch holds about as many
//     threads as the card holds of that instance (krep_dfa_resident_threads,
//     the occupancy calculator's figure), a power of two from 16 B or a
//     multiple of 128 B, and at least four halos: 16 MiB launches about
//     2^18 threads too, and no instance runs a second, partial wave.
// Table kind and mask are template arguments (6 instances), picked by
// krep_dfa_scan; the hot loop tests neither.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum TableKind { kSharedTable = 0, kGlobalTable = 1, kWideTable = 2 };

// 258 * 2 B a state: at most 94,944 B of table beside 16 KB of mask rows,
// so two 1,024-thread blocks fit an SM's 228 KB
constexpr int kSharedMaxStates = 184;
constexpr int kRowStride = 258;        // shared table entries per state
constexpr int kChunk = 128;            // mask bytes a thread stages before its warp writes them

template <int kKind>
struct Traits {
  static constexpr int kThreads = kKind == kSharedTable ? 1024 : 256;
  static constexpr int kMinBlocks = kKind == kSharedTable ? 2 : 1;
  // a thread's emissions: at most 65,536 positions (the longest span) of
  // counts under 2^16 fit 32 bits, unless the counts come from emit[]
  using Acc = std::conditional_t<kKind == kWideTable, unsigned long long, uint32_t>;
};

// The 0/1 bytes of a nibble's 4 bits (the four shifted copies do not overlap).
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// One step of the walk: the entry reached from entry e on byte b; its
// emissions are added to acc and, with kMask, its flag is returned.
template <int kKind>
__device__ __forceinline__ uint32_t dfa_step(uint32_t& e, uint32_t b, const uint16_t* sh_tab,
                                             const uint32_t* tab, const int* emit,
                                             typename Traits<kKind>::Acc& acc) {
  if (kKind == kSharedTable) {
    e = sh_tab[e + b];
    const uint32_t f = e & 1u;
    const uint32_t c = f ? uint32_t(sh_tab[e - 1]) : 0u;  // predicated: the flagged row's pad slot
    acc += c;
    return f;
  } else {
    e = __ldg(tab + (((e & 0xFFFFu) << 8) | b));
    const uint32_t hi = e >> 16;
    if (kKind == kGlobalTable) {
      acc += hi;
    } else {
      const int c = hi ? __ldg(emit + (e & 0xFFFFu)) : 0;  // predicated: counts past 16 bits
      acc += unsigned(c);
    }
    return hi != 0u;
  }
}

template <int kKind, bool kMask>
__global__ void __launch_bounds__(Traits<kKind>::kThreads, Traits<kKind>::kMinBlocks)
dfa_scan_kernel(const uint8_t* __restrict__ text, long long n, long long body, long long n_lanes,
                int span, int halo, const uint32_t* __restrict__ table, int table_vecs,
                const int* __restrict__ emit, uint32_t entry0, uint8_t* __restrict__ mask,
                unsigned long long* __restrict__ total) {
  constexpr int kThreads = Traits<kKind>::kThreads;
  extern __shared__ uint4 dyn[];
  __shared__ __align__(16) uint16_t stage[kMask ? kThreads * (kChunk / 16) : 1];  // 16 bits a step
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const uint16_t* sh_tab = reinterpret_cast<const uint16_t*>(dyn);
  if (kKind == kSharedTable) {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    for (int i = threadIdx.x; i < table_vecs; i += kThreads) dyn[i] = __ldg(src + i);
    __syncthreads();
  }
  const int t = threadIdx.x, lane = t & 31;
  const long long me = static_cast<long long>(blockIdx.x) * kThreads + t;
  const long long start = me * span;
  // positions of this thread's span below n: 0..span
  const int own = me < n_lanes ? int(max(0LL, min(n - start, static_cast<long long>(span)))) : 0;
  typename Traits<kKind>::Acc acc = 0;
  uint32_t e = entry0;
  if (own > 0) {
    for (int p = -halo; p < 0; ++p) {
      const uint32_t b = start + p >= 0 ? __ldg(text + start + p) : 0u;
      typename Traits<kKind>::Acc none = 0;
      dfa_step<kKind>(e, b, sh_tab, table, emit, none);
    }
  }
  const uint4* src = reinterpret_cast<const uint4*>(text + start);
  const int chunk = min(span, kChunk);
  uint4 nxt = own > 0 ? __ldg(src) : make_uint4(0, 0, 0, 0);
  for (int c0 = 0; c0 < span; c0 += chunk) {
    if (!kMask && c0 >= own) break;
#pragma unroll 1
    for (int s = 0; s < chunk; s += 16) {
      const int p = c0 + s;
      uint32_t bits = 0;
      if (p < own) {
        const uint4 v = nxt;
        if (p + 16 < own) nxt = __ldg(src + (p >> 4) + 1);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        if (p + 16 <= own) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t f = dfa_step<kKind>(e, (w[j >> 2] >> (8 * (j & 3))) & 0xFFu, sh_tab,
                                               table, emit, acc);
            if (kMask) bits |= f << j;
          }
        } else {
          const int left = own - p;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < left) {
              const uint32_t f = dfa_step<kKind>(e, (w[j >> 2] >> (8 * (j & 3))) & 0xFFu,
                                                 sh_tab, table, emit, acc);
              if (kMask) bits |= f << j;
            }
          }
        }
      }
      if (kMask) stage[t * (kChunk / 16) + (s >> 4)] = uint16_t(bits);
    }
    if (kMask) {
      // the warp's 32 runs of `chunk` flags, as 0/1 bytes: word q of run j
      // (positions 4q..4q+3) from nibble q of its bits; consecutive g are
      // consecutive addresses within a run, and runs of a chunk under 128 B
      // are the warp's contiguous spans, so each store is a whole line (a
      // line past the body, in the last span, is not stored)
      __syncwarp();
      const int qlog = 31 - __clz(chunk) - 2;  // log2(words of a run): chunk is a power of two
      const long long warp0 = me - lane;
      const uint32_t* rows = reinterpret_cast<const uint32_t*>(stage) + (t - lane) * (kChunk / 32);
#pragma unroll 1
      for (int g = lane; g < (32 << qlog); g += 32) {
        const int j = g >> qlog, q = g & ((1 << qlog) - 1);
        const long long at = (warp0 + j) * span + c0 + 4 * q;
        if (warp0 + j < n_lanes && at < body) {
          const uint32_t word = rows[j * (kChunk / 32) + (q >> 3)];
          *reinterpret_cast<uint32_t*>(mask + at) = spread4((word >> (4 * (q & 7))) & 15u);
        }
      }
      __syncwarp();  // the next chunk rewrites the rows
    }
  }
  unsigned long long sum = acc;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xFFFFFFFFu, sum, d);
  if (lane == 0) warp_sums[t >> 5] = sum;
  __syncthreads();
  if (t == 0) {
    unsigned long long block = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) block += warp_sums[w];
    if (block) atomicAdd(total, block);
  }
}

// The dynamic shared memory of an instance for a table of `table_bytes`,
// opted in above 48 KB (per device: set at every call).
template <int kKind, bool kMask>
int dynamic_smem(long long table_bytes, int* smem) {
  *smem = kKind == kSharedTable ? int((table_bytes + 15) / 16 * 16) : 0;
  if (kKind != kSharedTable) return 0;
  return int(cudaFuncSetAttribute(dfa_scan_kernel<kKind, kMask>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, *smem));
}

template <int kKind, bool kMask>
int launch(const uint8_t* text, long long n, long long body, int span, int halo,
           const uint32_t* table, long long table_bytes, const int* emit, uint32_t entry0,
           uint8_t* mask, unsigned long long* total, cudaStream_t stream) {
  constexpr int kThreads = Traits<kKind>::kThreads;
  int smem;
  if (const int err = dynamic_smem<kKind, kMask>(table_bytes, &smem)) return err;
  const long long n_lanes = (body + span - 1) / span;
  const unsigned grid = unsigned((n_lanes + kThreads - 1) / kThreads);
  dfa_scan_kernel<kKind, kMask><<<grid, kThreads, smem, stream>>>(
      text, n, body, n_lanes, span, halo, table, smem / 16, emit, entry0, mask, total);
  return int(cudaGetLastError());
}

// The threads of an instance that the current device holds at once.
template <int kKind, bool kMask>
long long resident_threads(long long table_bytes) {
  constexpr int kThreads = Traits<kKind>::kThreads;
  int smem, blocks = 0, device = 0, sms = 0;
  if (dynamic_smem<kKind, kMask>(table_bytes, &smem) || cudaGetDevice(&device) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dfa_scan_kernel<kKind, kMask>,
                                                    kThreads, smem))
    return -1;
  return static_cast<long long>(blocks) * kThreads * sms;
}

}  // namespace

// The dense-DFA walk of the first n bytes of a staged text over a body of
// `body` bytes (n <= body, `body` a multiple of 128; `text` 16-byte and
// `mask` 128-byte aligned; `span` a power of two from 16 to 64, or a
// multiple of 128 up to 65,536: the last thread's span may pass the body):
// `table` is the packed table of ops/ac.py pack_dense_table, `kind` its
// kind (0 shared: 16-bit entries in rows of 258, `table_bytes` of them, at
// most kSharedMaxStates states and counts of 16 bits; 1 global: [S, 256]
// 32-bit entries, state | count << 16; 2 wide: the same with counts
// clamped, the exact ones from `emit`, [S] int32), `entry0` the entry of
// the start state, `halo` the longest pattern's length minus one; -i is in
// the table. Adds the emissions at every position below n to *total (a
// zeroed uint64) and, when `mask` is not null, writes its 0/1 flags of the
// positions where an emission is non-zero over the whole body. Returns the
// launch's cudaGetLastError().
extern "C" int krep_dfa_scan(const void* text, long long n, long long body, int span, int halo,
                             int kind, const void* table, long long table_bytes,
                             const void* emit, unsigned int entry0, void* mask, void* total,
                             void* stream) {
  const bool span_ok = span < 128 ? span >= 16 && !(span & (span - 1))
                                  : span % 128 == 0 && span <= 65536;
  if (n < 0 || n > body || body % 128 || !span_ok || halo < 0 || !total || kind < 0 ||
      kind > 2 || (kind == kWideTable && !emit))
    return int(cudaErrorInvalidValue);
  if (kind == kSharedTable && table_bytes > 2LL * kRowStride * kSharedMaxStates + 16)
    return int(cudaErrorInvalidValue);
  if ((body + span - 1) / span / 256 >= 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  auto t = static_cast<const uint8_t*>(text);
  auto tab = static_cast<const uint32_t*>(table);
  auto em = static_cast<const int*>(emit);
  auto m = static_cast<uint8_t*>(mask);
  auto tot = static_cast<unsigned long long*>(total);
  auto s = static_cast<cudaStream_t>(stream);
#define KREP_DFA(K)                                                                          \
  return m ? launch<K, true>(t, n, body, span, halo, tab, table_bytes, em, entry0, m, tot, s) \
           : launch<K, false>(t, n, body, span, halo, tab, table_bytes, em, entry0, m, tot, s)
  switch (kind) {
    case kSharedTable: KREP_DFA(kSharedTable);
    case kGlobalTable: KREP_DFA(kGlobalTable);
    default: KREP_DFA(kWideTable);
  }
#undef KREP_DFA
}

// The threads that the current device holds at once for the instance of
// `kind` (and `mask`) with a table of `table_bytes` (the occupancy
// calculator's blocks per SM x threads x SMs), -1 on an error: the wrapper
// sizes the spans so that one launch fills the card once.
extern "C" long long krep_dfa_resident_threads(int kind, int mask, long long table_bytes) {
  switch (kind * 2 + (mask ? 1 : 0)) {
    case 0: return resident_threads<kSharedTable, false>(table_bytes);
    case 1: return resident_threads<kSharedTable, true>(table_bytes);
    case 2: return resident_threads<kGlobalTable, false>(table_bytes);
    case 3: return resident_threads<kGlobalTable, true>(table_bytes);
    case 4: return resident_threads<kWideTable, false>(table_bytes);
    case 5: return resident_threads<kWideTable, true>(table_bytes);
    default: return -1;
  }
}
