// Timing variants of the image decode (B1, decode_images.cu) on Hopper: a probe
// that ranks what bounds B1, each variant writing the same bytes.
//
// Replaces the TPU ablation kernel scratch/ablate_decode.py::build_variant (body
// make_kernel_variant, :38-198), which timed variants of the production Pallas
// kernel, each byte-equal to its base. Here every variant decodes a shared-table
// batch of 8x8 blocks with the 1-D delta (the only precoder the TPU ablation
// ran, :221) and, except xorfold, writes B1's (T, bh*8, bw*8) uint8 image. The
// variants, each changing one thing of B1's body:
//
//   base     B1's decode_group as it is: 15 interval compares per symbol and
//            the adj value read from shared memory (the TPU's gatheradj).
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
// The TPU's stride2/4/8 (one-hot refill scans by stride) and maxw's refill
// range (bounded by the widest code) have no counterpart: a CUDA thread reads
// its words at their address.
//
// What the probe tells: the time of base less that of xorfold is what B1's
// row stores cost; base against pruned and lut is what the compare chain
// costs; base against ilp2 is what the latency of one serial chain per thread
// costs. What bounds each variant on the H100 is what bounds B1, the decode's
// instructions, less what the variant removes (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::IntervalTable;
using mht::kThreads;

// the variant ids of probes/ablate_decode.py::VARIANTS
constexpr int kBase = 0, kPruned = 1, kLut = 2, kIlp2 = 3, kXorfold = 4;
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

struct Launch {
  const uint32_t* words;
  uint64_t last_word;
  const uint32_t* offsets;
  int64_t n_blocks, bh, bw;
  IntervalTable tab;
  PrunedTable ptab;
  const uint8_t* symbols;
  const uint16_t* t1;
  const uint16_t* t2;
  int n_t2;
  uint8_t* out;
  cudaStream_t stream;
};

template <int V, int N, bool T2_SMEM>
void launch(const Launch& a, size_t smem) {
  const unsigned grid = (unsigned)((a.n_blocks + kThreads - 1) / kThreads);
  ablate_kernel<V, N, T2_SMEM><<<grid, kThreads, smem, a.stream>>>(
      a.words, a.last_word, a.offsets, a.n_blocks, a.bh, a.bw, a.tab, a.ptab,
      a.symbols, a.t1, a.t2, a.n_t2, a.out);
}

// pruned: a switch over the term count into its template instance
template <int N = 0>
void launch_pruned(const Launch& a, int n_terms) {
  if constexpr (N <= kMaxTerms) {
    if (n_terms == N) {
      launch<kPruned, N, false>(a, 0);
    } else {
      launch_pruned<N + 1>(a, n_terms);
    }
  }
}

}  // namespace

// Decode n_blocks = T*bh*bw 8x8 blocks with the 1-D delta, as variant
// `variant` (0 base, 1 pruned, 2 lut, 3 ilp2, 4 xorfold). The arguments are
// decode_images.cu's (words, offsets, the interval table, symbols, out), plus:
// pruned's n_terms (0..15) distinct bounds `term_bounds`, their increments
// `term_incs` and `term_base` (see PrunedTable; the other variants pass 0
// terms and NULL arrays); lut's T1 (256 u16 entries)
// and T2 (n_t2 tables of 256 u16, n_t2 >= 1) on the device. out: the
// (T, bh*8, bw*8) uint8 image, or for xorfold n_blocks u64. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mht_ablate_decode(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bh, int64_t bw,
                                 const uint32_t* bounds, const int32_t* adj,
                                 const void* symbols, int variant, int n_terms,
                                 const uint32_t* term_bounds,
                                 const int32_t* term_incs, int32_t term_base,
                                 const void* t1, const void* t2, int n_t2,
                                 void* out, void* stream) {
  if (n_words < 3 || n_blocks <= 0 || bh <= 0 || bw <= 0 || variant < kBase ||
      variant > kXorfold || n_terms < 0 || n_terms > kMaxTerms ||
      (variant == kLut && (t1 == nullptr || t2 == nullptr || n_t2 < 1 ||
                           n_t2 > 256))) {
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
  a.last_word = (uint64_t)(n_words - 3);
  a.offsets = static_cast<const uint32_t*>(offsets);
  a.n_blocks = n_blocks;
  a.bh = bh;
  a.bw = bw;
  a.symbols = static_cast<const uint8_t*>(symbols);
  a.t1 = static_cast<const uint16_t*>(t1);
  a.t2 = static_cast<const uint16_t*>(t2);
  a.n_t2 = n_t2;
  a.out = static_cast<uint8_t*>(out);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase:
      launch<kBase, 0, false>(a, 0);
      break;
    case kPruned:
      launch_pruned(a, n_terms);
      break;
    case kLut: {
      const size_t t2_bytes = (size_t)n_t2 * 256 * sizeof(uint16_t);
      const size_t t1_bytes = 256 * sizeof(uint16_t);
      if (t1_bytes + t2_bytes <= (size_t)kLutSmemBytes) {
        launch<kLut, 0, true>(a, t1_bytes + t2_bytes);
      } else {
        launch<kLut, 0, false>(a, t1_bytes);
      }
      break;
    }
    case kIlp2: {
      const unsigned grid =
          (unsigned)((n_blocks + 2 * kThreads - 1) / (2 * kThreads));
      ilp2_kernel<<<grid, kThreads, 0, a.stream>>>(
          a.words, a.last_word, a.offsets, n_blocks, bh, bw, a.tab, a.symbols,
          a.out);
      break;
    }
    default:
      launch<kXorfold, 0, false>(a, 0);
  }
  return (int)cudaGetLastError();
}
