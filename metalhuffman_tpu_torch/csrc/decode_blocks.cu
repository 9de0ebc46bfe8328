// Shared-table canonical Huffman decode into packed blocks, on Hopper.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/decode_pallas.py::decode_tiles
// (body _make_kernel in packed-block mode, decode_pallas.py:405-479). It
// computes the same bytes: num_steps canonical-Huffman symbols per block (4,
// 16, 64 or 256: square blocks of 2, 4, 8 or 16), decoded 4 at a time from a
// 64-bit window, with the 1-D delta undone in the symbol chain across the whole
// block, the 2-D predictor undone in registers at num_steps == 64 only (as
// _make_kernel allows, :215-216; other sizes leave residuals for the caller's
// torch post-pass), or no precoder. Output is the stream order of
// unpack_to_blocks (:693-697): block b's symbols at bytes
// [b*num_steps, (b+1)*num_steps), one little-endian u32 per 4-symbol group.
// Given an end pointer it also stores each block's row-local end bit,
// (offset & 31) + bits consumed, the TPU kernel's loop carry.
//
// Design: one CUDA thread per block, 256 threads per CUDA block, blocks in the
// order of the offset index. Offsets may come in any order and may repeat (a
// region selection passes its grid's blocks row by row, with offsets rebased
// by a multiple of 32 bits), since a thread reads only its own offset and
// writes only its own output row. The refill and the symbol decode are the
// ones of the image kernel (decode_common.cuh). A 16x16 block can hold 4096
// bits; the refill still reads at most words (pos>>5)+2, so the two pad words
// of ops/decode_cuda.prepare_stream hold for every block size.
//
// What bounds it on the H100: the serial decode chain of each block
// (num_steps dependent width/index/lookup steps), not memory bandwidth. At
// 16x16 a 2048x1536 image has only 12,288 blocks, under one wave of 132 SMs x
// 2048 threads, so one long chain per thread sets the time; at 2x2 it has
// 786,432 threads of one group each, and the per-thread set-up (table staging,
// offset load, index arithmetic) weighs as much as the decode. The stores of
// a warp at num_steps >= 16 are strided by the block size, not coalesced.
// Later work: output staging through shared memory, several blocks per thread
// at small num_steps.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::IntervalTable;
using mht::kThreads;

// MODE 0: no precoder; 1: 1-D delta over the whole block; 2: delta2d, 8x8
// blocks only (n_groups == 16: two groups per 8-pixel row).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
                     const uint32_t* __restrict__ offsets, int64_t n_blocks,
                     int n_groups, const __grid_constant__ IntervalTable tab,
                     const uint8_t* __restrict__ symbols,
                     uint32_t* __restrict__ out, int32_t* __restrict__ end) {
  __shared__ uint8_t s_sym[256];
  __shared__ int32_t s_adj[16];
  mht::stage_table(tab, symbols, s_sym, s_adj);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  uint32_t* dst = out + b * n_groups;
  const uint32_t start = offsets[b];
  uint64_t pos = start;
  uint32_t prev = 0;  // 1-D delta accumulator, reset per block
  if (MODE == 2) {
    uint64_t prev_row = 0;  // the reconstructed row above
#pragma unroll 1
    for (int dy = 0; dy < 8; ++dy) {
      uint32_t lo, hi;
      pos += mht::decode_group<false>(words, last_word, pos, tab, s_sym, s_adj,
                                      prev, lo);
      pos += mht::decode_group<false>(words, last_word, pos, tab, s_sym, s_adj,
                                      prev, hi);
      prev_row = mht::delta2d_row(dy, ((uint64_t)hi << 32) | lo, prev_row);
      // 64-byte block rows: dst + 2*dy is 8-byte aligned
      *reinterpret_cast<uint64_t*>(dst + 2 * dy) = prev_row;
    }
  } else {
#pragma unroll 1
    for (int g = 0; g < n_groups; ++g) {
      uint32_t packed;
      pos += mht::decode_group<MODE == 1>(words, last_word, pos, tab, s_sym,
                                          s_adj, prev, packed);
      dst[g] = packed;
    }
  }
  if (end != nullptr) end[b] = mht::row_local_end(start, pos);
}

}  // namespace

// Decode n_blocks blocks of num_steps symbols each into out, an (n_blocks,
// num_steps) uint8 buffer in the order of the offset index. words: n_words >=
// 3 big-endian u32 code words; offsets: n_blocks u32 bit offsets; bounds/adj:
// 16 host values each (the interval table); symbols: 256 device bytes
// (canonical order); num_steps: a multiple of 4 in [4, 256]; mode: 0 none,
// 1 delta, 2 delta2d (num_steps == 64 only); end: NULL, or n_blocks int32 for
// the row-local end bits. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int mht_decode_blocks(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int num_steps, const uint32_t* bounds,
                                 const int32_t* adj, const void* symbols,
                                 int mode, void* out, void* end, void* stream) {
  if (n_words < 3 || n_blocks <= 0 || num_steps < 4 || num_steps > 256 ||
      num_steps % 4 || mode < 0 || mode > 2 || (mode == 2 && num_steps != 64)) {
    return (int)cudaErrorInvalidValue;
  }
  IntervalTable tab;
  for (int i = 0; i < 16; ++i) {
    tab.bounds[i] = bounds[i];
    tab.adj[i] = adj[i];
  }
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* o = static_cast<const uint32_t*>(offsets);
  const auto* sy = static_cast<const uint8_t*>(symbols);
  auto* dst = static_cast<uint32_t*>(out);
  auto* e = static_cast<int32_t*>(end);
  const uint64_t last_word = (uint64_t)(n_words - 3);
  const int n_groups = num_steps / 4;
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    decode_blocks_kernel<0><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, n_groups, tab, sy, dst, e);
  } else if (mode == 1) {
    decode_blocks_kernel<1><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, n_groups, tab, sy, dst, e);
  } else {
    decode_blocks_kernel<2><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, n_groups, tab, sy, dst, e);
  }
  return (int)cudaGetLastError();
}
