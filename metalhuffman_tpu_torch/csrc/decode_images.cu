// Shared-table canonical Huffman decode of a batch of 8x8-block images on Hopper.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/decode_pallas.py::_make_kernel in
// image-emission mode, launched by decode_tiles_images (decode_pallas.py:485-546).
// It computes the same bytes: 64 canonical-Huffman symbols per block, decoded by
// canonical-interval arithmetic from a 64-bit window refilled once per group of
// 4 symbols, the precoder undone in registers (1-D delta in the symbol chain,
// the 2-D predictor per 8-pixel row, or none), and each block row stored at its
// final image position.
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
// shared memory once per CUDA block.
//
// What bounds it on the H100: the serial decode chain of each block (64
// dependent width/index/lookup steps, 15 compares each) and the scattered
// 8-byte row stores (one thread writes 8 rows that lie a frame row apart), not
// memory bandwidth: a 94 MB batch reads ~55 MB of code words and writes 94 MB.
// Later work: coalesced output staging through shared memory, several symbols
// per refill, a lookup table in place of the compare chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct IntervalTable {
  // bounds[L-1] = left-justified first code of length L (16-bit space).
  // A bound of 0 always holds and one >= 2^16 never does, so the count below
  // needs no pruning of absent code lengths.
  uint32_t bounds[16];
  // adj[w-1] = (codes shorter than w) - (first right-justified code of
  // length w); may be negative. idx = adj[w-1] + (window >> (16 - w)).
  int32_t adj[16];
};

__device__ __forceinline__ uint64_t swar_add8(uint64_t a, uint64_t b) {
  // bytewise mod-256 add of 8 packed bytes, no carry between bytes
  const uint64_t low7 = 0x7F7F7F7F7F7F7F7FULL;
  const uint64_t hi = 0x8080808080808080ULL;
  return ((a & low7) + (b & low7)) ^ ((a ^ b) & hi);
}

// MODE 0: no precoder; 1: 1-D delta (running sum over the block's 64 symbols);
// 2: delta2d (row 0 running sum along the row, later rows add the row above).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
decode_images_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
                     const uint32_t* __restrict__ offsets, int64_t n_blocks,
                     int64_t bh, int64_t bw, IntervalTable tab,
                     const uint8_t* __restrict__ symbols,
                     uint8_t* __restrict__ out) {
  __shared__ uint8_t s_sym[256];
  __shared__ int32_t s_adj[16];
  s_sym[threadIdx.x] = symbols[threadIdx.x];
  if (threadIdx.x == 0) {
    // static indices: a dynamic index into the by-value table would copy
    // it to the stack
#pragma unroll
    for (int i = 0; i < 16; ++i) s_adj[i] = tab.adj[i];
  }
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const int64_t per_frame = bh * bw;
  const int64_t f = b / per_frame;
  const int64_t r = b - f * per_frame;
  const int64_t by = r / bw;
  const int64_t bx = r - by * bw;
  const int64_t row_bytes = bw * 8;
  uint8_t* dst = out + ((f * bh + by) * 8) * row_bytes + bx * 8;

  uint64_t pos = offsets[b];  // absolute bit position; may pass 2^32
  uint32_t prev = 0;          // 1-D delta accumulator, reset per block
  uint64_t prev_row = 0;      // delta2d: the reconstructed row above
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint64_t row = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // refill: 64-bit window left-justified at `pos` from words wi..wi+2.
      // A well-formed stream never needs the clamp (prepare_stream pads);
      // it keeps a malformed offset index inside the buffer.
      uint64_t wi = pos >> 5;
      if (wi > last_word) wi = last_word;
      const uint32_t s = (uint32_t)(pos & 31);
      const uint64_t w01 = ((uint64_t)words[wi] << 32) | words[wi + 1];
      // (uint64_t)w2 >> (32 - s) is defined for s == 0 in 64 bits
      const uint64_t win = (w01 << s) | ((uint64_t)words[wi + 2] >> (32 - s));
      uint32_t t = 0;  // bits consumed in this group, <= 48 before symbol 3
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t window = (uint32_t)((win << t) >> 48);
        int w = 1;
#pragma unroll
        for (int L = 1; L < 16; ++L) w += window >= tab.bounds[L];
        const int32_t idx = s_adj[w - 1] + (int32_t)(window >> (16 - w));
        uint32_t sym = s_sym[idx & 255];
        if (MODE == 1) {
          prev = (prev + sym) & 0xFF;
          sym = prev;
        }
        row |= (uint64_t)sym << (8 * (4 * half + k));
        t += w;
      }
      pos += t;
    }
    if (MODE == 2) {
      if (dy == 0) {  // prefix sum of the 8 bytes along the row
        row = swar_add8(row, row << 8);
        row = swar_add8(row, row << 16);
        row = swar_add8(row, row << 32);
      } else {
        row = swar_add8(row, prev_row);
      }
      prev_row = row;
    }
    *reinterpret_cast<uint64_t*>(dst + dy * row_bytes) = row;
  }
}

}  // namespace

// Decode n_blocks = T*bh*bw blocks into out, a (T, bh*8, bw*8) uint8 buffer.
// words: n_words >= 3 big-endian u32 code words; offsets: n_blocks u32 bit
// offsets; bounds/adj: 16 host values each (the interval table); symbols: 256
// device bytes (canonical order); mode: 0 none, 1 delta, 2 delta2d. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mht_decode_images(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bh, int64_t bw,
                                 const uint32_t* bounds, const int32_t* adj,
                                 const void* symbols, int mode, void* out,
                                 void* stream) {
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
  const uint64_t last_word = (uint64_t)(n_words - 3);
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    decode_images_kernel<0><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, bh, bw, tab, sy, dst);
  } else if (mode == 1) {
    decode_images_kernel<1><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, bh, bw, tab, sy, dst);
  } else {
    decode_images_kernel<2><<<grid, kThreads, 0, st>>>(
        w, last_word, o, n_blocks, bh, bw, tab, sy, dst);
  }
  return (int)cudaGetLastError();
}
