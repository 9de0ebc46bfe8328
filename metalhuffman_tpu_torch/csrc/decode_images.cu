// Shared-table canonical Huffman decode of a batch of 8x8-block images on Hopper.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/decode_pallas.py::_make_kernel in
// image-emission mode, launched by decode_tiles_images (decode_pallas.py:485-546).
// It computes the same bytes: 64 canonical-Huffman symbols per block, decoded by
// canonical-interval arithmetic from a 64-bit window refilled once per group of
// 4 symbols, the precoder undone in registers (1-D delta in the symbol chain,
// the 2-D predictor per 8-pixel row, or none), and each block row stored at its
// final image position. Given an end pointer it also stores each block's
// row-local end bit, the TPU kernel's emit_end output (decode_pallas.py:
// 396-397), for the on-device integrity check.
//
// Design: one CUDA thread per 8x8 block, 256 threads per CUDA block, over all
// T*bh*bw blocks of the batch in raster block order with frames concatenated
// (core/blocks.py::image_to_blocks). A thread reads the packed big-endian u32
// word stream directly at its block's bit offset, so none of the TPU staging
// (per-block word rows, (8,128) tiles, the h-major feed permutation, the
// 1024-pixel ImagePlan padding) exists here: those were there only because
// Mosaic has no per-lane addressing. The table is the same for the whole batch
// and is passed per launch: the 16 interval bounds and the 16 cumulative adj
// values by value, the 256-byte canonical symbol order by pointer, staged into
// shared memory once per CUDA block. The refill and the symbol decode live in
// decode_common.cuh, shared with the packed-block kernel (decode_blocks.cu).
//
// What bounds it on the H100, as the probes of metalhuffman_tpu_torch/probes
// measured it on the 30x2048x1536 photo batch (PERF.md): the instructions of
// the 15-compare interval chain, not memory bandwidth (a 94 MB batch reads
// ~55 MB of code words and writes 94 MB, 0.045 ms at 3.35 TB/s, against
// ~0.35 ms). A two-level lookup table in place of the chain decodes the same
// bytes 2.9x faster, and compares pruned to the table's code lengths with a
// fused width/adj sum 1.3x faster; dropping 7 of every 8 row stores, staging
// the rows through shared memory for 16-byte stores, or two chains per thread
// move it by under 5 %: a warp's 8-byte row stores already cover 256
// contiguous bytes, and the chains' latency is hidden. Later work: the lookup
// table (queue B), then several symbols per refill.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::IntervalTable;
using mht::kThreads;

// MODE 0: no precoder; 1: 1-D delta (running sum over the block's 64 symbols);
// 2: delta2d (row 0 running sum along the row, later rows add the row above).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
decode_images_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
                     const uint32_t* __restrict__ offsets, int64_t n_blocks,
                     int64_t bh, int64_t bw,
                     const __grid_constant__ IntervalTable tab,
                     const uint8_t* __restrict__ symbols,
                     uint8_t* __restrict__ out, int32_t* __restrict__ end) {
  __shared__ uint8_t s_sym[256];
  __shared__ int32_t s_adj[16];
  mht::stage_table(tab, symbols, s_sym, s_adj);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const int64_t row_bytes = bw * 8;
  uint8_t* dst = mht::block_origin(out, b, bh, bw);

  const uint32_t start = offsets[b];
  uint64_t pos = start;   // absolute bit position; may pass 2^32
  uint32_t prev = 0;      // 1-D delta accumulator, reset per block
  uint64_t prev_row = 0;  // delta2d: the reconstructed row above
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint32_t lo, hi;  // pixels 0..3 and 4..7 of block row dy
    pos += mht::decode_group<MODE == 1>(words, last_word, pos, tab, s_sym,
                                        s_adj, prev, lo);
    pos += mht::decode_group<MODE == 1>(words, last_word, pos, tab, s_sym,
                                        s_adj, prev, hi);
    uint64_t row = ((uint64_t)hi << 32) | lo;
    if (MODE == 2) row = prev_row = mht::delta2d_row(dy, row, prev_row);
    *reinterpret_cast<uint64_t*>(dst + dy * row_bytes) = row;
  }
  if (end != nullptr) end[b] = mht::row_local_end(start, pos);
}

}  // namespace

// Decode n_blocks = T*bh*bw blocks into out, a (T, bh*8, bw*8) uint8 buffer.
// words: n_words >= 3 big-endian u32 code words; offsets: n_blocks u32 bit
// offsets; bounds/adj: 16 host values each (the interval table); symbols: 256
// device bytes (canonical order); mode: 0 none, 1 delta, 2 delta2d; end: NULL,
// or n_blocks int32 for the row-local end bits. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mht_decode_images(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bh, int64_t bw,
                                 const uint32_t* bounds, const int32_t* adj,
                                 const void* symbols, int mode, void* out,
                                 void* end, void* stream) {
  if (n_words < 3 || n_blocks <= 0 || bh <= 0 || bw <= 0 || mode < 0 ||
      mode > 2) {
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
  auto* dst = static_cast<uint8_t*>(out);
  auto* e = static_cast<int32_t*>(end);
  const uint64_t last_word = (uint64_t)(n_words - 3);
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    decode_images_kernel<0><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, bh, bw, tab, sy, dst, e);
  } else if (mode == 1) {
    decode_images_kernel<1><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, bh, bw, tab, sy, dst, e);
  } else {
    decode_images_kernel<2><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, bh, bw, tab, sy, dst, e);
  }
  return (int)cudaGetLastError();
}
