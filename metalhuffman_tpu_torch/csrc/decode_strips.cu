// Image decode with the output staged as strips in shared memory, on Hopper: a
// probe of B1 (decode_images.cu) whose stores are coalesced.
//
// Replaces the TPU prototype scratch/kernel_strips.py::decode_strips (body
// make_kernel, :28-108), B1 with the 1-D delta whose kernel lane-interleaves
// each block row so that it stores image strips and only a coarse chunk swap
// is left after it. It computes B1's bytes: a shared-table batch of 8x8 blocks
// with the 1-D delta (the prototype's only precoder, :85) into a
// (T, bh*8, bw*8) uint8 image.
//
// Design: a CUDA block of 256 threads decodes 256 consecutive blocks of the
// raster block order, one per thread with B1's decode step (decode_common.cuh),
// into a 16 KB strip in shared memory, row dy of local block k at strip[dy][k]
// (a warp's 8-byte stores fill 256 contiguous bytes: no bank conflicts). Then
// the block stores the strip by pixel row: two neighbouring blocks' row words
// as one 16-byte store, consecutive threads on consecutive addresses, in
// place of B1's 8-byte stores, each thread's 8 a frame row apart (a warp's
// 32 of one row cover 256 contiguous bytes). A run of 256 blocks may cross
// a block row or a frame (1920x1080 has bw = 240): each 16-byte pair finds its
// own image position, and a pair never straddles a block row because bw is
// even. An odd bw stores 8 bytes per block instead.
//
// What bounds it on the H100: the decode chain's instructions, as B1. The probe
// measures what whole-row stores save against B1's per-warp 256-byte ones, at
// the price of a __syncthreads and a pass through shared memory: nothing, it
// runs a few percent slower than B1 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::IntervalTable;
using mht::kThreads;

__global__ void __launch_bounds__(kThreads)
decode_strips_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
                     const uint32_t* __restrict__ offsets, int64_t n_blocks,
                     int64_t bh, int64_t bw,
                     const __grid_constant__ IntervalTable tab,
                     const uint8_t* __restrict__ symbols,
                     uint8_t* __restrict__ out) {
  __shared__ uint8_t s_sym[256];
  __shared__ int32_t s_adj[16];
  __shared__ __align__(16) uint64_t strip[8][kThreads];
  mht::stage_table(tab, symbols, s_sym, s_adj);
  __syncthreads();

  const int64_t b0 = (int64_t)blockIdx.x * kThreads;
  const int64_t b = b0 + threadIdx.x;
  if (b < n_blocks) {
    uint64_t pos = offsets[b];
    uint32_t prev = 0;
#pragma unroll 1
    for (int dy = 0; dy < 8; ++dy) {
      uint32_t lo, hi;
      pos += mht::decode_group<true>(words, last_word, pos, tab, s_sym, s_adj,
                                     prev, lo);
      pos += mht::decode_group<true>(words, last_word, pos, tab, s_sym, s_adj,
                                     prev, hi);
      strip[dy][threadIdx.x] = ((uint64_t)hi << 32) | lo;
    }
  }
  __syncthreads();

  const int64_t row_bytes = bw * 8;
  if ((bw & 1) == 0) {
    // 8 rows x 128 pairs of blocks; a warp stores 32 pairs of one row
    constexpr int kPairs = kThreads / 2;
#pragma unroll
    for (int i = 0; i < 8 * kPairs / kThreads; ++i) {
      const int c = i * kThreads + threadIdx.x;
      const int dy = c / kPairs;
      const int p = c % kPairs;
      const int64_t bb = b0 + 2 * p;
      if (bb >= n_blocks) continue;  // n_blocks is even: pairs are whole
      const uint4 v = *reinterpret_cast<const uint4*>(&strip[dy][2 * p]);
      *reinterpret_cast<uint4*>(mht::block_origin(out, bb, bh, bw) +
                                dy * row_bytes) = v;
    }
  } else if (b < n_blocks) {  // B1's stores, from the strip
    uint8_t* dst = mht::block_origin(out, b, bh, bw);
#pragma unroll
    for (int dy = 0; dy < 8; ++dy) {
      *reinterpret_cast<uint64_t*>(dst + dy * row_bytes) =
          strip[dy][threadIdx.x];
    }
  }
}

}  // namespace

// Decode n_blocks = T*bh*bw 8x8 blocks with the 1-D delta into out, a
// 16-byte aligned (T, bh*8, bw*8) uint8 buffer. The arguments are those of
// decode_images.cu's mht_decode_images without mode and end. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mht_decode_strips(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bh, int64_t bw,
                                 const uint32_t* bounds, const int32_t* adj,
                                 const void* symbols, void* out, void* stream) {
  if (n_words < 3 || n_blocks <= 0 || bh <= 0 || bw <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  IntervalTable tab;
  for (int i = 0; i < 16; ++i) {
    tab.bounds[i] = bounds[i];
    tab.adj[i] = adj[i];
  }
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  decode_strips_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), (uint64_t)(n_words - 3),
      static_cast<const uint32_t*>(offsets), n_blocks, bh, bw, tab,
      static_cast<const uint8_t*>(symbols), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
