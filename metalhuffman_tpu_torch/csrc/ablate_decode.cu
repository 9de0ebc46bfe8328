// Timing variants of the image decode (B1, decode_images.cu) on Hopper: a
// probe that ranks changes to B1's body, each variant writing the same bytes.
//
// Replaces the TPU ablation kernel scratch/ablate_decode.py::build_variant
// (body make_kernel_variant, :38-198), which timed variants of the production
// Pallas kernel, each byte-equal to its base. Here every variant decodes a
// shared-table batch of 8x8 blocks with the 1-D delta (the only precoder the
// TPU ablation ran, :221) and, except xorfold, writes B1's (T, bh*8, bw*8)
// uint8 image.
//
// Two families. The first five variants keep the interval body B1 ran before
// its lookup-table redesign, the record of what bounded it then (PERF.md); each
// changes one thing of that body:
//
//   base     the interval body: decode_group's 15 interval compares per symbol
//            and the adj value read from shared memory (the TPU's gatheradj),
//            one CUDA block per 256 blocks.
//   pruned   compares only for the code lengths the table has, at most 15
//            distinct bounds 0 < B < 2^16, with the TPU's fused accumulator
//            acc = w + 256*(adj + 2^16) (make_kernel_variant :155-162) and no
//            adj lookup. The term list is a kernel argument; the term count is
//            a template parameter, one instance per count, so the chain unrolls
//            (the TPU pruned at trace time, :42-52).
//   lut      the reference's two-level 8/8 lookup table (HuffmanUtil.cpp:
//            338-667; decode_xla.py:48-104) in place of the compare chain: T1
//            (256 entries) in shared memory, T2 in shared memory when the
//            table's secondary tables fit in 48 KB, else read through L1. An
//            entry is width*256 + symbol (core/tables.py::pack_entries); a T1
//            escape (width 0) names the T2 table. 4 symbols per refill, as B1.
//   ilp2     each thread carries two blocks' chains (blocks b and b+256 of its
//            CUDA block), interleaved in one loop: more independent chains per
//            thread (the TPU's g12/g16, more chains per program).
//   xorfold  base's decode, but each thread stores one u64, the XOR of its
//            block's 8 row words, in place of 8 row stores a frame row apart:
//            the store ablation. Output (n_blocks,) u64 in raster block order.
//
// The b1 family starts from B1 as it is now, decode_images_kernel<1, true>: the
// same grid, the same bulk copy of the 11/5 lookup table into shared memory
// (decode_common.cuh::stage_lut) on the same launch path (launch_facts), the
// same 8-byte row stores. Each variant changes one thing:
//
//   b1           B1's body unchanged, through decode_group_lut: the yardstick,
//                which must time as B1 itself does in the same rounds.
//   b1_esc32     u32 entries: a T1 escape holds its secondary table's index in
//                the whole table (0x80000000 | (2^11 + 32 t)), so the escape
//                path is one lop3 ((e & 0x7fffffff) | (window & 31)) and one
//                load, in place of B1's mask, shift, mask, OR and load. T1 is
//                8 KB, T2 at most 24 KB for a complete code.
//   b1_refill64  the refill from two aligned 8-byte loads of the 128 bits at
//                pos & ~63, in place of three 4-byte loads; the words wanted
//                are picked by bit 5 of pos (the u32 words are native values of
//                big-endian words, so a u64 holds its two words swapped: the
//                pick is register naming, no instruction).
//   b1_row8      8 symbols per refill: a 128-bit window from three aligned
//                8-byte loads, one refill per block row in place of two; the
//                second 4 symbols read the window shifted by the bits the first
//                took (at most 64, so 8 symbols of 16 bits just fit).
//   b1_esc32_row8  b1_esc32's table and b1_row8's refill together: the two
//                changes that each gained in one content (PERF.md), joined.
//   b1_s1smem    b1 with S1's span buffer and strip (decode_strips.cu) as
//                unused shared memory beside the table: B1 at S1's 4 CUDA
//                blocks per SM, the control that splits S1's time into
//                what its residency costs and what its bulk copies move.
//
// The wider refills read further ahead than B1's; near the buffer's end (and
// for B1's clamp of a malformed position) they take B1's refill, a branch
// that a well-formed stream takes only in its last words, so every variant
// writes B1's bytes on any stream.
//
// The TPU's stride2/4/8 (one-hot refill scans by stride) and maxw's refill
// range (bounded by the widest code) have no counterpart: a CUDA thread reads
// its words at their address.
//
// What the probe tells: the time of base less that of xorfold is what the
// interval body's row stores cost; base against pruned and lut is what the
// compare chain costs; base against ilp2 is what the latency of one serial
// chain per thread costs. Each b1 variant against b1, in the same rounds, is
// what its change of B1's body would move. What bounds each variant on the
// H100 is what bounds its family's body, the decode's instructions per symbol,
// less what the variant removes (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::IntervalTable;
using mht::kThreads;

// the variant ids of probes/ablate_decode.py::VARIANTS
constexpr int kBase = 0, kPruned = 1, kLut = 2, kIlp2 = 3, kXorfold = 4;
constexpr int kB1 = 5, kEsc32 = 6, kRefill64 = 7, kRow8 = 8, kEsc32Row8 = 9,
              kB1S1Smem = 10;
// b1_s1smem's padding: decode_strips.cu's span buffer and strip
// (kSpanWords words and 8 rows of kSlots u64), beside the table
constexpr uint32_t kS1ExtraBytes = 4 * 8200 + 8 * (256 + 8) * 8;
constexpr int kMaxTerms = 15;
// T2 goes to shared memory up to this size with T1 (no opt-in needed)
constexpr int kLutSmemBytes = 48 * 1024;

struct PrunedTable {
  // distinct interval bounds 0 < B < 2^16, ascending
  uint32_t bound[kMaxTerms];
  // per bound: (code lengths that start there) + 256 * (their adj increments)
  int32_t inc[kMaxTerms];
  // base_w + 256 * (base_adj + 2^16): the width and adj when no bound holds
  int32_t base;
};

// The delta, and the symbol's byte in the packed group.
__device__ __forceinline__ void emit(uint32_t sym, int k, uint32_t& prev,
                                     uint32_t& out) {
  prev = (prev + sym) & 0xFF;
  out |= prev << (8 * k);
}

// pruned: decode_group with N compare terms and the fused accumulator.
template <int N>
__device__ __forceinline__ uint32_t group_pruned(
    const uint32_t* __restrict__ words, uint64_t last_word, uint64_t pos,
    const PrunedTable& tab, const uint8_t* s_sym, uint32_t& prev,
    uint32_t& packed) {
  const uint64_t win = mht::refill(words, last_word, pos);
  uint32_t t = 0, out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t window = (uint32_t)((win << t) >> 48);
    int32_t acc = tab.base;
#pragma unroll
    for (int i = 0; i < N; ++i) acc += window >= tab.bound[i] ? tab.inc[i] : 0;
    const uint32_t w = (uint32_t)acc & 0xFF;
    const int32_t idx = ((acc >> 8) - 65536) + (int32_t)(window >> (16 - w));
    emit(s_sym[idx & 255], k, prev, out);
    t += w;
  }
  packed = out;
  return t;
}

// lut: decode_group through the two-level table. A zero entry (T2's reserved
// slot 0, reached only from a malformed stream) has width 0: the group then
// stops advancing, and every read stays inside the tables.
__device__ __forceinline__ uint32_t group_lut(
    const uint32_t* __restrict__ words, uint64_t last_word, uint64_t pos,
    const uint16_t* s_t1, const uint16_t* __restrict__ t2, uint32_t& prev,
    uint32_t& packed) {
  const uint64_t win = mht::refill(words, last_word, pos);
  uint32_t t = 0, out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t window = (uint32_t)((win << t) >> 48);
    uint32_t e = s_t1[window >> 8];
    if ((e >> 8) == 0) e = t2[((e & 0xFF) << 8) | (window & 0xFF)];
    emit(e & 0xFF, k, prev, out);
    t += e >> 8;
  }
  packed = out;
  return t;
}

// One thread per block: V is kBase, kPruned, kLut or kXorfold; N is pruned's
// term count; T2_SMEM puts lut's T2 in shared memory.
template <int V, int N, bool T2_SMEM>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
              const uint32_t* __restrict__ offsets, int64_t n_blocks,
              int64_t bh, int64_t bw, const __grid_constant__ IntervalTable tab,
              const __grid_constant__ PrunedTable ptab,
              const uint8_t* __restrict__ symbols,
              const uint16_t* __restrict__ t1, const uint16_t* __restrict__ t2,
              int n_t2, uint8_t* __restrict__ out) {
  extern __shared__ uint16_t s_lut[];  // lut: T1, then T2 when T2_SMEM
  __shared__ uint8_t s_sym[256];
  __shared__ int32_t s_adj[16];
  if (V == kLut) {
    s_lut[threadIdx.x] = t1[threadIdx.x];
    if (T2_SMEM) {
      for (int i = threadIdx.x; i < n_t2 * 256; i += kThreads) {
        s_lut[256 + i] = t2[i];
      }
    }
  } else {
    mht::stage_table(tab, symbols, s_sym, s_adj);
  }
  __syncthreads();
  const uint16_t* lut_t2 = T2_SMEM ? s_lut + 256 : t2;

  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  uint64_t pos = offsets[b];
  uint32_t prev = 0;
  uint64_t folded = 0;
  uint8_t* dst = V == kXorfold ? nullptr : mht::block_origin(out, b, bh, bw);
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint32_t half[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (V == kPruned) {
        pos += group_pruned<N>(words, last_word, pos, ptab, s_sym, prev, half[i]);
      } else if (V == kLut) {
        pos += group_lut(words, last_word, pos, s_lut, lut_t2, prev, half[i]);
      } else {
        pos += mht::decode_group<true>(words, last_word, pos, tab, s_sym, s_adj,
                                       prev, half[i]);
      }
    }
    const uint64_t row = ((uint64_t)half[1] << 32) | half[0];
    if (V == kXorfold) {
      folded ^= row;
    } else {
      *reinterpret_cast<uint64_t*>(dst + dy * (bw * 8)) = row;
    }
  }
  if (V == kXorfold) reinterpret_cast<uint64_t*>(out)[b] = folded;
}

// Two blocks per thread, b and b + kThreads, their chains interleaved.
__global__ void __launch_bounds__(kThreads)
ilp2_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
            const uint32_t* __restrict__ offsets, int64_t n_blocks, int64_t bh,
            int64_t bw, const __grid_constant__ IntervalTable tab,
            const uint8_t* __restrict__ symbols, uint8_t* __restrict__ out) {
  __shared__ uint8_t s_sym[256];
  __shared__ int32_t s_adj[16];
  mht::stage_table(tab, symbols, s_sym, s_adj);
  __syncthreads();

  const int64_t b0 = (int64_t)blockIdx.x * (2 * kThreads) + threadIdx.x;
  if (b0 >= n_blocks) return;
  // a second block past the batch decodes the first one's bits again and
  // stores nothing
  const int64_t b1 = b0 + kThreads;
  const bool has1 = b1 < n_blocks;
  uint8_t* dst0 = mht::block_origin(out, b0, bh, bw);
  uint8_t* dst1 = has1 ? mht::block_origin(out, b1, bh, bw) : dst0;
  uint64_t pos0 = offsets[b0];
  uint64_t pos1 = has1 ? offsets[b1] : pos0;
  uint32_t prev0 = 0, prev1 = 0;
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint32_t lo0, lo1, hi0, hi1;
    pos0 += mht::decode_group<true>(words, last_word, pos0, tab, s_sym, s_adj,
                                    prev0, lo0);
    pos1 += mht::decode_group<true>(words, last_word, pos1, tab, s_sym, s_adj,
                                    prev1, lo1);
    pos0 += mht::decode_group<true>(words, last_word, pos0, tab, s_sym, s_adj,
                                    prev0, hi0);
    pos1 += mht::decode_group<true>(words, last_word, pos1, tab, s_sym, s_adj,
                                    prev1, hi1);
    *reinterpret_cast<uint64_t*>(dst0 + dy * (bw * 8)) =
        ((uint64_t)hi0 << 32) | lo0;
    if (has1) {
      *reinterpret_cast<uint64_t*>(dst1 + dy * (bw * 8)) =
          ((uint64_t)hi1 << 32) | lo1;
    }
  }
}

// ---- the b1 family -------------------------------------------------------

// b1_esc32's escape: the secondary table's index in the whole table from an
// escaping entry e = 0x80000000 | base (base a multiple of 32) and the window,
// (e & 0x7fffffff) | (window & 31), as one lop3: with c = kEsc32Mask, each
// bit is c ? (window & ~e) : e, truth table 0x58 (a = e, b = window).
constexpr uint32_t kEsc32Mask = 0x80000000u | ((1u << mht::kK2) - 1);

__device__ __forceinline__ uint32_t esc32_index(uint32_t e, uint32_t window) {
  uint32_t i;
  asm("lop3.b32 %0, %1, %2, %3, 0x58;"
      : "=r"(i) : "r"(e), "r"(window), "r"(kEsc32Mask));
  return i;
}

// decode_window_lut (1-D delta) through the u32 table: s_tab holds T1 and,
// with T2_SMEM, T2; tab is the whole table in global memory.
template <bool T2_SMEM>
__device__ __forceinline__ uint32_t window_esc32(
    uint64_t win, const int32_t* s_tab, const int32_t* __restrict__ tab,
    uint32_t& prev, uint32_t& packed) {
  uint32_t t = 0, out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t window = (uint32_t)((win << t) >> 48);
    int32_t e = s_tab[window >> mht::kK2];
    if (e < 0) {
      const uint32_t i = esc32_index((uint32_t)e, window);
      e = T2_SMEM ? s_tab[i] : __ldg(tab + i);
    }
    emit((uint32_t)e & 0xFF, k, prev, out);
    t += (uint32_t)e >> 8;
  }
  packed = out;
  return t;
}

// The 64 bits left-justified at bit s of word w0, from words w0, w1, w2
// (mht::refill's arithmetic on words it was handed).
__device__ __forceinline__ uint64_t window_at(uint32_t w0, uint32_t w1,
                                              uint32_t w2, uint32_t s) {
  // (uint64_t)w2 >> (32 - s) is defined for s == 0 in 64 bits
  return ((((uint64_t)w0 << 32) | w1) << s) | ((uint64_t)w2 >> (32 - s));
}

// B1's refill (mht::refill) from two aligned 8-byte loads. fast_last is the
// last word index at which both loads stay inside the buffer (n_words - 3
// for an even n_words, n_words - 4 for an odd one, so never past B1's
// clamp; negative for a buffer too short for them); past it, B1's refill
// with its clamp.
__device__ __forceinline__ uint64_t refill64(const uint32_t* __restrict__ words,
                                             uint64_t last_word,
                                             int64_t fast_last, uint64_t pos) {
  if ((int64_t)(pos >> 5) > fast_last) {
    return mht::refill(words, last_word, pos);
  }
  const uint2* p = reinterpret_cast<const uint2*>(words) + (pos >> 6);
  const uint2 a = p[0], b = p[1];
  const bool odd = (pos & 32) != 0;
  return window_at(odd ? a.y : a.x, odd ? b.x : a.y, odd ? b.y : b.x,
                   (uint32_t)(pos & 31));
}

// One CUDA thread per 8x8 block, as decode_images_kernel<1, T2_SMEM>, with
// its parameters in its order and its end-bit epilogue (the probe passes no
// end pointer), so that b1 compiles to B1's code. V is kB1, kEsc32,
// kRefill64, kRow8, kEsc32Row8 or kB1S1Smem. table: the u16 lookup table
// (the u32 one for kEsc32 and kEsc32Row8), stage_bytes of it copied to
// shared memory. fast_last: the last word index at which refill64's loads
// stay in the buffer (kRefill64), or at which the three loads of a row's
// refill do (n_words - 5 even, n_words - 6 odd).
template <int V, bool T2_SMEM>
__global__ void __launch_bounds__(kThreads)
b1_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
          const uint32_t* __restrict__ offsets, uint32_t n_blocks,
          uint32_t bh, uint32_t bw, const int16_t* __restrict__ table,
          uint32_t stage_bytes, uint8_t* __restrict__ out,
          int32_t* __restrict__ end, int64_t fast_last) {
  extern __shared__ __align__(128) int16_t s_tab[];
  __shared__ uint64_t bar;
  mht::stage_lut(table, stage_bytes, s_tab, &bar);
  const uint32_t b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const int16_t* t2 = (T2_SMEM ? s_tab : table) + (1 << mht::kK1);
  const int32_t* s_tab32 = reinterpret_cast<const int32_t*>(s_tab);
  const int32_t* tab32 = reinterpret_cast<const int32_t*>(table);

  const int64_t row_bytes = (int64_t)bw * 8;
  uint8_t* dst = mht::block_origin32(out, b, bh, bw);
  const uint32_t start = offsets[b];
  uint64_t pos = start;  // absolute bit position; may pass 2^32
  uint32_t prev = 0;     // 1-D delta accumulator
  constexpr bool kEsc = V == kEsc32 || V == kEsc32Row8;
  constexpr bool kRow = V == kRow8 || V == kEsc32Row8;
  // 4 symbols from the window at their first bit, by the variant's table
  auto step = [&](uint64_t win, uint32_t& packed) -> uint32_t {
    if constexpr (kEsc) {
      return window_esc32<T2_SMEM>(win, s_tab32, tab32, prev, packed);
    } else {
      return mht::decode_window_lut<T2_SMEM, true>(win, s_tab, t2, prev,
                                                   packed);
    }
  };
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint32_t lo, hi;  // pixels 0..3 and 4..7 of block row dy
    if (V == kB1 || V == kB1S1Smem) {
      pos += mht::decode_group_lut<T2_SMEM, true>(words, last_word, pos, s_tab,
                                                  t2, prev, lo);
      pos += mht::decode_group_lut<T2_SMEM, true>(words, last_word, pos, s_tab,
                                                  t2, prev, hi);
    } else if (V == kEsc32) {
      pos += step(mht::refill(words, last_word, pos), lo);
      pos += step(mht::refill(words, last_word, pos), hi);
    } else if (V == kRefill64) {
      pos += step(refill64(words, last_word, fast_last, pos), lo);
      pos += step(refill64(words, last_word, fast_last, pos), hi);
    } else if (kRow && (int64_t)(pos >> 5) <= fast_last) {  // a row's 128 bits
      const uint2* p = reinterpret_cast<const uint2*>(words) + (pos >> 6);
      const uint2 a = p[0], b2 = p[1], c = p[2];
      const bool odd = (pos & 32) != 0;
      const uint32_t s = (uint32_t)(pos & 31);
      const uint32_t w2 = odd ? b2.y : b2.x;
      const uint64_t top = window_at(odd ? a.y : a.x, odd ? b2.x : a.y, w2, s);
      const uint64_t low = window_at(w2, odd ? c.x : b2.y, odd ? c.y : c.x, s);
      const uint32_t t = step(top, lo);
      // the 64 bits at pos + t, 4 <= t <= 64 (every entry is 1..16 bits)
      const uint64_t next = ((top << (t - 1)) << 1) | (low >> (64 - t));
      pos += t + step(next, hi);
    } else {  // a row near the buffer's end: B1's two refills
      pos += step(mht::refill(words, last_word, pos), lo);
      pos += step(mht::refill(words, last_word, pos), hi);
    }
    *reinterpret_cast<uint64_t*>(dst + dy * row_bytes) =
        ((uint64_t)hi << 32) | lo;
  }
  if (end != nullptr) end[b] = mht::row_local_end(start, pos);
}

// ---- launches --------------------------------------------------------------

struct Launch {
  const uint32_t* words;
  int64_t n_words;
  uint64_t last_word;
  const uint32_t* offsets;
  int64_t n_blocks, bh, bw;
  IntervalTable tab;
  PrunedTable ptab;
  const uint8_t* symbols;
  const uint16_t* t1;
  const uint16_t* t2;
  int n_t2;
  const int16_t* table;  // the b1 family's lookup table
  uint32_t stage_bytes;  // and the bytes of it staged in shared memory
  uint8_t* out;
  cudaStream_t stream;
};

unsigned grid_of(int64_t n_blocks, int per_cta) {
  return (unsigned)((n_blocks + per_cta - 1) / per_cta);
}

// Launch `kernel` over `grid` 256-thread CUDA blocks with `smem` bytes of
// dynamic shared memory, or with shape_only only describe that launch;
// per_sm is its CUDA blocks per SM when known (0: ask the runtime).
template <typename... P, typename... A>
int go(void (*kernel)(P...), unsigned grid, uint32_t smem, int per_sm,
       bool shape_only, mht::GridShape* shape, cudaStream_t stream,
       A... args) {
  if (shape_only) {
    shape->grid = (int)grid;
    shape->dyn_smem = (int)smem;
    shape->ctas_per_sm = per_sm;
    if (per_sm == 0) {
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &shape->ctas_per_sm, kernel, kThreads, smem);
      if (err != cudaSuccess) return (int)err;
    }
    return mht::kernel_attributes(kernel, shape);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int V, int N, bool T2_SMEM>
int run_interval(const Launch& a, uint32_t smem, bool shape_only,
                 mht::GridShape* shape) {
  return go(ablate_kernel<V, N, T2_SMEM>, grid_of(a.n_blocks, kThreads), smem,
            0, shape_only, shape, a.stream, a.words, a.last_word, a.offsets,
            a.n_blocks, a.bh, a.bw, a.tab, a.ptab, a.symbols, a.t1, a.t2,
            a.n_t2, a.out);
}

// pruned: a switch over the term count into its template instance
template <int N = 0>
int run_pruned(const Launch& a, int n_terms, bool shape_only,
               mht::GridShape* shape) {
  if constexpr (N <= kMaxTerms) {
    if (n_terms == N) return run_interval<kPruned, N, false>(a, 0, shape_only,
                                                             shape);
    return run_pruned<N + 1>(a, n_terms, shape_only, shape);
  }
  return (int)cudaErrorInvalidValue;
}

// The b1 family on B1's launch path: launch_facts opts the kernel in to the
// table's shared memory and knows its occupancy. b1_s1smem launches with S1's
// shared memory per CUDA block beside the table, unused, so at S1's
// residency.
template <int V, bool T2_SMEM>
int run_b1(const Launch& a, bool shape_only, mht::GridShape* shape) {
  static mht::KernelCache cache;
  auto* kernel = b1_kernel<V, T2_SMEM>;
  const uint32_t pad = V == kB1S1Smem ? kS1ExtraBytes : 0;
  const uint32_t smem = a.stage_bytes + pad;
  int sms = 0, per_sm = 0;
  const int err = mht::launch_facts(kernel, cache, smem, &sms, &per_sm,
                                    mht::kT2SmemMaxBytes + pad);
  if (err) return err;
  // the last word index at which the variant's aligned loads stay in the
  // buffer: refill64 reads up to word (wi | 1) + 2, a row's refill up to
  // (wi | 1) + 4
  const int64_t fast_last =
      a.n_words - (V == kRow8 || V == kEsc32Row8 ? 5 : 3) - (a.n_words & 1);
  return go(kernel, grid_of(a.n_blocks, kThreads), smem, per_sm,
            shape_only, shape, a.stream, a.words, a.last_word, a.offsets,
            (uint32_t)a.n_blocks, (uint32_t)a.bh, (uint32_t)a.bw, a.table,
            a.stage_bytes, a.out, static_cast<int32_t*>(nullptr), fast_last);
}

template <int V>
int dispatch_b1(const Launch& a, int t2_smem, bool shape_only,
                mht::GridShape* shape) {
  return t2_smem ? run_b1<V, true>(a, shape_only, shape)
                 : run_b1<V, false>(a, shape_only, shape);
}

// b1_esc32's table: u32 entries, T1 of 2^11 then secondary tables of 2^5;
// the bytes staged (all of it with T2 in shared memory, else T1), or 0 when
// the table is malformed.
uint32_t esc32_stage_bytes(int64_t entries, int t2_smem) {
  const int64_t t1 = (int64_t)1 << mht::kK1;
  const int64_t per_t2 = (int64_t)1 << mht::kK2;
  if (entries < t1 || (entries - t1) % per_t2 || (entries - t1) / per_t2 > t1) {
    return 0;
  }
  const int64_t bytes = 4 * (t2_smem ? entries : t1);
  if (t2_smem && bytes > (int64_t)mht::kT2SmemMaxBytes) return 0;
  return (uint32_t)bytes;
}

int run(Launch& a, int variant, int n_terms, int64_t table_entries,
        int t2_smem, bool shape_only, mht::GridShape* shape) {
  if (variant >= kB1) {
    // a block index, and each block row and column, fit in 32 bits, as in B1
    a.stage_bytes = variant == kEsc32 || variant == kEsc32Row8
                        ? esc32_stage_bytes(table_entries, t2_smem)
                        : mht::lut_stage_bytes(table_entries, t2_smem);
    if (a.n_blocks > INT32_MAX || a.bh * a.bw > INT32_MAX ||
        a.stage_bytes == 0 ||
        (variant >= kRefill64 && variant <= kEsc32Row8 &&
         reinterpret_cast<uintptr_t>(a.words) % 8 != 0)) {
      return (int)cudaErrorInvalidValue;
    }
    if (variant == kB1) return dispatch_b1<kB1>(a, t2_smem, shape_only, shape);
    if (variant == kEsc32) {
      return dispatch_b1<kEsc32>(a, t2_smem, shape_only, shape);
    }
    if (variant == kRefill64) {
      return dispatch_b1<kRefill64>(a, t2_smem, shape_only, shape);
    }
    if (variant == kRow8) {
      return dispatch_b1<kRow8>(a, t2_smem, shape_only, shape);
    }
    if (variant == kEsc32Row8) {
      return dispatch_b1<kEsc32Row8>(a, t2_smem, shape_only, shape);
    }
    return dispatch_b1<kB1S1Smem>(a, t2_smem, shape_only, shape);
  }
  switch (variant) {
    case kBase:
      return run_interval<kBase, 0, false>(a, 0, shape_only, shape);
    case kPruned:
      return run_pruned(a, n_terms, shape_only, shape);
    case kLut: {
      const uint32_t t2_bytes = (uint32_t)a.n_t2 * 256 * sizeof(uint16_t);
      const uint32_t t1_bytes = 256 * sizeof(uint16_t);
      if (t1_bytes + t2_bytes <= (uint32_t)kLutSmemBytes) {
        return run_interval<kLut, 0, true>(a, t1_bytes + t2_bytes, shape_only,
                                           shape);
      }
      return run_interval<kLut, 0, false>(a, t1_bytes, shape_only, shape);
    }
    case kIlp2:
      return go(ilp2_kernel, grid_of(a.n_blocks, 2 * kThreads), 0, 0,
                shape_only, shape, a.stream, a.words, a.last_word, a.offsets,
                a.n_blocks, a.bh, a.bw, a.tab, a.symbols, a.out);
    default:
      return run_interval<kXorfold, 0, false>(a, 0, shape_only, shape);
  }
}

bool bad_variant(int variant, int n_terms, int n_t2) {
  return variant < kBase || variant > kB1S1Smem || n_terms < 0 ||
         n_terms > kMaxTerms || (variant == kLut && (n_t2 < 1 || n_t2 > 256));
}

}  // namespace

// Decode n_blocks = T*bh*bw 8x8 blocks with the 1-D delta, as variant
// `variant` (0 base, 1 pruned, 2 lut, 3 ilp2, 4 xorfold, 5 b1, 6 b1_esc32,
// 7 b1_refill64, 8 b1_row8, 9 b1_esc32_row8, 10 b1_s1smem). The arguments
// are decode_images.cu's (words, offsets, out) and the interval table
// (bounds, adj, symbols), plus: pruned's n_terms (0..15) distinct bounds
// `term_bounds`, their increments `term_incs` and `term_base` (see
// PrunedTable; the other variants pass 0 terms and NULL arrays); lut's T1
// (256 u16 entries) and T2 (n_t2 tables of 256 u16, n_t2 >= 1) on the
// device; the b1 family's lookup table on the device, 16-byte aligned,
// table_entries entries (u16 as mht_decode_images takes it, u32 for b1_esc32
// and b1_esc32_row8) and t2_smem (1: the whole table in shared memory, at
// most 64 KB; 0: T2 through L1). b1_refill64, b1_row8 and b1_esc32_row8 need
// 8-byte aligned words. out: the (T, bh*8, bw*8) uint8 image, or for xorfold
// n_blocks u64. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int mht_ablate_decode(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bh, int64_t bw,
                                 const uint32_t* bounds, const int32_t* adj,
                                 const void* symbols, int variant, int n_terms,
                                 const uint32_t* term_bounds,
                                 const int32_t* term_incs, int32_t term_base,
                                 const void* t1, const void* t2, int n_t2,
                                 const void* table, int64_t table_entries,
                                 int t2_smem, void* out, void* stream) {
  if (n_words < 3 || n_blocks <= 0 || bh <= 0 || bw <= 0 ||
      bad_variant(variant, n_terms, n_t2) ||
      (variant == kLut && (t1 == nullptr || t2 == nullptr)) ||
      (variant >= kB1 && table == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Launch a{};
  for (int i = 0; i < 16; ++i) {
    a.tab.bounds[i] = bounds[i];
    a.tab.adj[i] = adj[i];
  }
  for (int i = 0; i < n_terms; ++i) {
    a.ptab.bound[i] = term_bounds[i];
    a.ptab.inc[i] = term_incs[i];
  }
  a.ptab.base = term_base;
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = n_words;
  a.last_word = (uint64_t)(n_words - 3);
  a.offsets = static_cast<const uint32_t*>(offsets);
  a.n_blocks = n_blocks;
  a.bh = bh;
  a.bw = bw;
  a.symbols = static_cast<const uint8_t*>(symbols);
  a.t1 = static_cast<const uint16_t*>(t1);
  a.t2 = static_cast<const uint16_t*>(t2);
  a.n_t2 = n_t2;
  a.table = static_cast<const int16_t*>(table);
  a.out = static_cast<uint8_t*>(out);
  a.stream = static_cast<cudaStream_t>(stream);
  mht::GridShape shape;
  return run(a, variant, n_terms, table_entries, t2_smem, false, &shape);
}

// The launch mht_ablate_decode makes for these arguments, and the kernel's
// occupancy, registers and local bytes, into shape[6] (mht::GridShape's
// fields in order). Launches nothing; returns a CUDA error (0 on success).
extern "C" int mht_ablate_decode_shape(int64_t n_blocks, int variant,
                                       int n_terms, int n_t2,
                                       int64_t table_entries, int t2_smem,
                                       int* shape) {
  if (n_blocks <= 0 || bad_variant(variant, n_terms, n_t2)) {
    return (int)cudaErrorInvalidValue;
  }
  Launch a{};
  a.n_words = 3;
  a.n_blocks = n_blocks;
  a.bh = a.bw = 1;
  a.n_t2 = n_t2;
  mht::GridShape s;
  const int err = run(a, variant, n_terms, table_entries, t2_smem, true, &s);
  if (err) return err;
  const int v[6] = {s.ctas_per_sm, s.grid, s.dyn_smem, s.static_smem,
                    s.registers, s.local_bytes};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  return 0;
}
