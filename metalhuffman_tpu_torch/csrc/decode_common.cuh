// The canonical-Huffman decode step shared by the port's decode kernels.
//
// Counterpart of the per-group body of metalhuffman_tpu/ops/decode_pallas.py::
// _make_kernel (`outer`), which serves both TPU kernels, decode_tiles_images
// and decode_tiles: refill a 64-bit window at the block's bit position, then
// decode 4 symbols from it by canonical-interval arithmetic. Both CUDA kernels
// (decode_images.cu, decode_blocks.cu) include it, so the two cannot drift.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mht {

constexpr int kThreads = 256;  // threads per CUDA block in every decode kernel

struct IntervalTable {
  // bounds[L-1] = left-justified first code of length L (16-bit space).
  // A bound of 0 always holds and one >= 2^16 never does, so the count below
  // needs no pruning of absent code lengths.
  uint32_t bounds[16];
  // adj[w-1] = (codes shorter than w) - (first right-justified code of
  // length w); may be negative. idx = adj[w-1] + (window >> (16 - w)).
  int32_t adj[16];
};

// Stage the launch's table into shared memory: the 256-byte canonical symbol
// order and the 16 adj values (read at a dynamic index). Needs kThreads
// threads and a __syncthreads() before the first use.
__device__ __forceinline__ void stage_table(const IntervalTable& tab,
                                            const uint8_t* __restrict__ symbols,
                                            uint8_t* s_sym, int32_t* s_adj) {
  s_sym[threadIdx.x] = symbols[threadIdx.x];
  if (threadIdx.x == 0) {
    // static indices: a dynamic index into the kernel's table argument would
    // copy it to the stack
#pragma unroll
    for (int i = 0; i < 16; ++i) s_adj[i] = tab.adj[i];
  }
}

// The 64-bit window of the big-endian word stream left-justified at absolute
// bit `pos`: enough for 4 symbols of up to 16 bits.
//
// It reads words pos>>5 .. (pos>>5)+2. The caller pads the stream so a
// well-formed block never needs more (each of a group's symbols takes at
// least one bit, so the last group of any block, of any size, starts at or
// before total_bits - 4); the clamp to last_word = n_words - 3 keeps a
// malformed offset or a desynchronised corrupt stream inside the buffer.
__device__ __forceinline__ uint64_t refill(const uint32_t* __restrict__ words,
                                           uint64_t last_word, uint64_t pos) {
  uint64_t wi = pos >> 5;
  if (wi > last_word) wi = last_word;
  const uint32_t s = (uint32_t)(pos & 31);
  const uint64_t w01 = ((uint64_t)words[wi] << 32) | words[wi + 1];
  // (uint64_t)w2 >> (32 - s) is defined for s == 0 in 64 bits
  return (w01 << s) | ((uint64_t)words[wi + 2] >> (32 - s));
}

// Decode the 4 symbols that start at absolute bit `pos` of the big-endian
// word stream. Returns the bits they took; `packed` gets them little-endian
// (symbol k in byte k). With DELTA each output is the running sum `prev` of
// the 1-D delta, carried across calls.
template <bool DELTA>
__device__ __forceinline__ uint32_t decode_group(
    const uint32_t* __restrict__ words, uint64_t last_word, uint64_t pos,
    const IntervalTable& tab, const uint8_t* s_sym, const int32_t* s_adj,
    uint32_t& prev, uint32_t& packed) {
  const uint64_t win = refill(words, last_word, pos);
  uint32_t t = 0;  // bits consumed in this group, <= 48 before symbol 3
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t window = (uint32_t)((win << t) >> 48);
    int w = 1;
#pragma unroll
    for (int L = 1; L < 16; ++L) w += window >= tab.bounds[L];
    const int32_t idx = s_adj[w - 1] + (int32_t)(window >> (16 - w));
    uint32_t sym = s_sym[idx & 255];
    if (DELTA) {
      prev = (prev + sym) & 0xFF;
      sym = prev;
    }
    out |= sym << (8 * k);
    t += w;
  }
  packed = out;
  return t;
}

// First byte of block b's top row in a (T, bh*8, bw*8) uint8 image batch,
// block b of the raster block order with frames concatenated.
__device__ __forceinline__ uint8_t* block_origin(uint8_t* out, int64_t b,
                                                 int64_t bh, int64_t bw) {
  const int64_t per_frame = bh * bw;
  const int64_t f = b / per_frame;
  const int64_t r = b - f * per_frame;
  const int64_t by = r / bw;
  const int64_t bx = r - by * bw;
  return out + ((f * bh + by) * 8) * (bw * 8) + bx * 8;
}

// bytewise mod-256 add of 8 packed bytes, no carry between bytes
__device__ __forceinline__ uint64_t swar_add8(uint64_t a, uint64_t b) {
  const uint64_t low7 = 0x7F7F7F7F7F7F7F7FULL;
  const uint64_t hi = 0x8080808080808080ULL;
  return ((a & low7) + (b & low7)) ^ ((a ^ b) & hi);
}

// delta2d on one 8-pixel row of an 8x8 block: row 0 becomes its prefix sum
// along the row, a later row adds the reconstructed row above.
__device__ __forceinline__ uint64_t delta2d_row(int dy, uint64_t row,
                                                uint64_t prev_row) {
  if (dy == 0) {
    row = swar_add8(row, row << 8);
    row = swar_add8(row, row << 16);
    return swar_add8(row, row << 32);
  }
  return swar_add8(row, prev_row);
}

// Row-local end bit of a block that started at `start` and now stands at
// `pos`: (start & 31) + bits consumed, the TPU kernel's loop carry.
__device__ __forceinline__ int32_t row_local_end(uint32_t start, uint64_t pos) {
  return (int32_t)((start & 31) + (uint32_t)(pos - start));
}

}  // namespace mht
