// Shared-table canonical Huffman decode of a batch of 8x8-block images on Hopper.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/decode_pallas.py::_make_kernel in
// image-emission mode, launched by decode_tiles_images (decode_pallas.py:485-546).
// It computes the same bytes: 64 canonical-Huffman symbols per block, decoded 4
// at a time from a 64-bit window refilled once per group, the precoder undone
// in registers (1-D delta in the symbol chain, the 2-D predictor per 8-pixel
// row, or none), and each block row stored at its final image position. Given
// an end pointer it also stores each block's row-local end bit, the TPU
// kernel's emit_end output (decode_pallas.py:396-397), for the on-device
// integrity check.
//
// Design: one CUDA thread per 8x8 block in raster block order with frames
// concatenated (core/blocks.py::image_to_blocks). A thread reads the packed
// big-endian u32 word stream directly at its block's bit offset, so none of
// the TPU staging (per-block word rows, (8,128) tiles, the h-major feed
// permutation, the 1024-pixel ImagePlan padding) exists here: those were there
// only because Mosaic has no per-lane addressing. A symbol is one lookup in a
// two-level table that tabulates the interval decode on every 16-bit window
// (decode_common.cuh::decode_group_lut), built on the host once per stream.
// The grid is one 256-thread CUDA block per 256 blocks, 8 resident per SM at
// 30 registers a thread. Each CUDA block stages the table into shared memory
// with one bulk copy on an mbarrier (4 KB of T1 and, for the photo, ~3 KB of
// secondary tables) while no thread waits on anything else; a persistent
// grid that staged it once per resident CUDA block and walked the blocks in
// a grid-stride loop ran a few percent slower in every timing (PERF.md). A
// table whose secondary tables would cut occupancy below 3 CUDA blocks per
// SM (over 64 KB: only the one-symbol code and malformed ones) keeps T2 in
// global memory, read through L1. The row stores stay 8 bytes a thread: a
// warp's 32 blocks of one block row cover 256 contiguous bytes of each pixel
// row.
//
// What bounds it on the H100: the instructions it runs per symbol, not
// bytes (it runs at about 40 % of its byte bound, PERF.md). Before this
// design the 15-compare interval chain of each symbol held B1 at ~13 % of
// that bound (csrc/ablate_decode.cu keeps that body as its `base`, and its
// b1 family times one change at a time of this kernel's body, as
// csrc/decode_strips.cu times bulk copies of its code words and image rows).
// The lookup takes the chain away: what ptxas leaves per symbol is the
// window extraction, the T1 load and its sign test, the width and the
// delta, plus the escape path (mask, index, T2 load), which it predicates
// and so runs for every symbol, escaping or not; and per group of 4 symbols
// the refill's three word loads. A warp-uniform branch around
// the escape path (a vote per symbol) cost more than the predicated path.
// What is left besides is one serial chain per block, whose latency the 64
// resident warps per SM hide.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::kThreads;

// MODE 0: no precoder; 1: 1-D delta (running sum over the block's 64 symbols);
// 2: delta2d (row 0 running sum along the row, later rows add the row above).
// T2_SMEM: T2 staged with T1, else read through L1.
template <int MODE, bool T2_SMEM>
__global__ void __launch_bounds__(kThreads)
decode_images_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
                     const uint32_t* __restrict__ offsets, uint32_t n_blocks,
                     uint32_t bh, uint32_t bw,
                     const int16_t* __restrict__ table, uint32_t stage_bytes,
                     uint8_t* __restrict__ out, int32_t* __restrict__ end) {
  extern __shared__ __align__(128) int16_t s_tab[];
  __shared__ uint64_t bar;
  mht::stage_lut(table, stage_bytes, s_tab, &bar);
  const uint32_t b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const int16_t* t2 = (T2_SMEM ? s_tab : table) + (1 << mht::kK1);

  const int64_t row_bytes = (int64_t)bw * 8;
  uint8_t* dst = mht::block_origin32(out, b, bh, bw);
  const uint32_t start = offsets[b];
  uint64_t pos = start;   // absolute bit position; may pass 2^32
  uint32_t prev = 0;      // 1-D delta accumulator
  uint64_t prev_row = 0;  // delta2d: the reconstructed row above
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint32_t lo, hi;  // pixels 0..3 and 4..7 of block row dy
    pos += mht::decode_group_lut<T2_SMEM, MODE == 1>(words, last_word, pos,
                                                     s_tab, t2, prev, lo);
    pos += mht::decode_group_lut<T2_SMEM, MODE == 1>(words, last_word, pos,
                                                     s_tab, t2, prev, hi);
    uint64_t row = ((uint64_t)hi << 32) | lo;
    if (MODE == 2) row = prev_row = mht::delta2d_row(dy, row, prev_row);
    *reinterpret_cast<uint64_t*>(dst + dy * row_bytes) = row;
  }
  if (end != nullptr) end[b] = mht::row_local_end(start, pos);
}

struct Args {
  const uint32_t* words;
  uint64_t last_word;
  const uint32_t* offsets;
  uint32_t n_blocks, bh, bw;
  const int16_t* table;
  uint32_t stage_bytes;
  uint8_t* out;
  int32_t* end;
  cudaStream_t stream;
};

// Launch (or with shape_only, only describe) one instance.
template <int MODE, bool T2_SMEM>
int run(const Args& a, bool shape_only, mht::GridShape* shape) {
  static mht::KernelCache cache;
  auto* kernel = decode_images_kernel<MODE, T2_SMEM>;
  int sms = 0;
  int err = mht::launch_facts(kernel, cache, a.stage_bytes, &sms,
                              &shape->ctas_per_sm);
  if (err) return err;
  shape->grid = (int)((a.n_blocks + kThreads - 1) / kThreads);
  shape->dyn_smem = (int)a.stage_bytes;
  if (shape_only) return mht::kernel_attributes(kernel, shape);
  kernel<<<shape->grid, kThreads, a.stage_bytes, a.stream>>>(
      a.words, a.last_word, a.offsets, a.n_blocks, a.bh, a.bw, a.table,
      a.stage_bytes, a.out, a.end);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const Args& a, int t2_smem, bool shape_only,
             mht::GridShape* shape) {
  return t2_smem ? run<MODE, true>(a, shape_only, shape)
                 : run<MODE, false>(a, shape_only, shape);
}

int decode(const void* words, int64_t n_words, const void* offsets,
           int64_t n_blocks, int64_t bh, int64_t bw, const void* table,
           int64_t table_entries, int t2_smem, int mode, void* out, void* end,
           void* stream, bool shape_only, mht::GridShape* shape) {
  const uint32_t stage_bytes = mht::lut_stage_bytes(table_entries, t2_smem);
  // a block index, and each block row and column, fit in 32 bits (2^31
  // blocks would be 137 GB of image)
  if (n_words < 3 || n_blocks <= 0 || n_blocks > INT32_MAX || bh <= 0 ||
      bw <= 0 || bh * bw > INT32_MAX || mode < 0 || mode > 2 ||
      stage_bytes == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const uint32_t*>(words),
               (uint64_t)(n_words - 3),
               static_cast<const uint32_t*>(offsets),
               (uint32_t)n_blocks, (uint32_t)bh, (uint32_t)bw,
               static_cast<const int16_t*>(table),
               stage_bytes,
               static_cast<uint8_t*>(out),
               static_cast<int32_t*>(end),
               static_cast<cudaStream_t>(stream)};
  if (mode == 0) return dispatch<0>(a, t2_smem, shape_only, shape);
  if (mode == 1) return dispatch<1>(a, t2_smem, shape_only, shape);
  return dispatch<2>(a, t2_smem, shape_only, shape);
}

}  // namespace

// Decode n_blocks = T*bh*bw blocks into out, a (T, bh*8, bw*8) uint8 buffer.
// words: n_words >= 3 big-endian u32 code words; offsets: n_blocks u32 bit
// offsets; table: the lookup table on the device, table_entries u16 (T1 of
// 2^11 entries, then the secondary tables of 2^5), 16-byte aligned; t2_smem:
// 1 to stage T2 in shared memory (at most 64 KB of table), 0 to read it
// through L1; mode: 0 none, 1 delta, 2 delta2d; end: NULL, or n_blocks int32
// for the row-local end bits. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int mht_decode_images(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bh, int64_t bw, const void* table,
                                 int64_t table_entries, int t2_smem, int mode,
                                 void* out, void* end, void* stream) {
  mht::GridShape shape;
  return decode(words, n_words, offsets, n_blocks, bh, bw, table,
                table_entries, t2_smem, mode, out, end, stream, false, &shape);
}

// The grid mht_decode_images launches for these arguments, and the kernel's
// occupancy, registers and local bytes, into shape[6] (mht::GridShape's
// fields in order). Launches nothing; returns a CUDA error (0 on success).
extern "C" int mht_decode_images_shape(int64_t n_blocks, int64_t table_entries,
                                       int t2_smem, int mode, int* shape) {
  mht::GridShape s;
  const int err = decode(nullptr, 3, nullptr, n_blocks, 1, 1, nullptr,
                         table_entries, t2_smem, mode, nullptr, nullptr,
                         nullptr, true, &s);
  if (err) return err;
  const int v[6] = {s.ctas_per_sm, s.grid, s.dyn_smem, s.static_smem,
                    s.registers, s.local_bytes};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  return 0;
}
