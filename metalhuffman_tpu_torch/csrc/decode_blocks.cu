// Shared-table canonical Huffman decode into packed blocks, on Hopper.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/decode_pallas.py::decode_tiles
// (body _make_kernel in packed-block mode, decode_pallas.py:405-479). It
// computes the same bytes: num_steps canonical-Huffman symbols per block, 1
// to 65025 (square blocks of 1x1 to 255x255, every size a container's
// block_dim byte records), decoded 4 at a time from a 64-bit window, with the
// 1-D delta undone in the symbol chain across the whole block, the 2-D
// predictor undone in registers at num_steps == 64 only (as _make_kernel
// allows, :215-216; other sizes leave residuals for the caller's torch
// post-pass), or no precoder. The TPU kernel takes multiples of 4 symbols
// (decode_pallas.py:431-435), the JAX package's XLA decode
// (ops/decode_xla.py::decode_blocks) any size; here a block whose num_steps
// % 4 is 1-3 ends with a short group of just those symbols
// (decode_common.cuh::decode_tail_lut), so its bytes and end bit are the XLA
// decode's. Output is the stream order of unpack_to_blocks (:693-697): block
// b's symbols at bytes [b*num_steps, (b+1)*num_steps). Given an end pointer
// it also stores each block's row-local end bit, (offset & 31) + bits
// consumed, the TPU kernel's loop carry.
//
// Design: one CUDA thread per block, blocks in the order of the offset index.
// Offsets may come in any order and may repeat (a region selection passes its
// grid's blocks row by row, with offsets rebased by a multiple of 32 bits),
// since a thread reads only its own offset. The decode step, the lookup table
// and its staging are the image kernel's (decode_images.cu,
// decode_common.cuh). The grid is persistent, for the occupancy cap below:
// as many CUDA blocks as the cap lets reside on the card at once, each
// staging the table once and walking the blocks in a grid-stride loop by
// warp (a warp takes 32 consecutive blocks). A 255x255 block can hold about
// a million bits; the refill still reads at most words (pos>>5)+2, so the two
// pad words of ops/decode_cuda.prepare_stream hold for every block size.
//
// The stores: a thread's output row is num_steps bytes, so at 16x16 a warp's
// 32 rows lie 256 bytes apart, and storing a u32 per group from each thread
// writes 4 bytes into each of 32 sectors per instruction (before this design
// B2 at 16x16 took 3x B1's time for the same bytes). Here each warp stages
// its rows in shared memory 8 groups (32 bytes a row) at a time, one padded
// row per lane (9 words: the lanes' u32 writes hit 32 distinct banks), and
// then stores them with consecutive lanes on consecutive addresses, in the
// widest unit every row start allows: 16-byte words where block_dim is a
// multiple of 4 (at 16x16 and 8x8 each instruction fills 16 whole 32-byte
// sectors, at 4x4 the warp's rows are one contiguous run), u32 where it is
// 2 mod 4 (2x2, 6x6), and single bytes where it is odd, so a row starts at
// any byte: a lane per byte, so a chunk of 32 bytes a row goes out as one
// row per instruction, and a block of up to 32 symbols puts the warp's rows
// out as one contiguous run. Lanes past the last block decode
// the last block again and store nothing, so the warp stays converged for
// __syncwarp.
//
// The occupancy: each thread streams its own block's code words through L1,
// three word loads per refill. At 16x16 a block is ~140 bytes, so 2048
// resident threads per SM need more lines than L1 holds and evict each
// other's before the next refill; the launch caps the CUDA blocks per SM so
// that the resident threads' blocks take at most kL1Bytes, from the stream's
// mean bytes per block: 3 per SM at 16x16, where both 2 and 4 or more ran
// slower in tuning, and all 8 at 4x4 and 8x8. Past 512 bytes a block (32x32
// and up) the cap is 1, the least a launch can have, and the L1 misses stay.
//
// What bounds it on the H100: at 4x4 the decode chain's instructions, as in
// B1; at 16x16 the refills' L1 misses at the capped occupancy and the wave
// tail: 368,640 one-block chains of 256 symbols for a 2048x1536 batch of 30
// frames are 3.6 per thread of the capped grid, so a quarter of the threads
// decode a fourth block while the others idle. That tail is inherent to one
// chain per block, and grows with the block: at 32x32 the same batch is
// 92,160 chains of 1024 symbols over 132 x 256 threads, about 2.7 waves of
// one thread per chain (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::kThreads;

constexpr int kChunk = 8;            // groups staged per row at a time
// L1 bytes the resident threads' code words may take (of the 256 KB an SM
// shares between L1 and shared memory)
constexpr int64_t kL1Bytes = 128 * 1024;
constexpr int kRowWords = kChunk + 1;  // padded staging row, in u32
// the most symbols a block holds: 255x255, the largest block_dim a
// container's header byte records (ops/decode_cuda.py::MAX_STEPS)
constexpr int kMaxSteps = 255 * 255;

// Store a warp's staged chunk in u32 or 16-byte units, for blocks of a
// multiple of 4 symbols: rows b0 .. b0+31 (those below n_blocks), cw groups
// each from group g0, from s_rows (32 rows of kRowWords u32).
__device__ __forceinline__ void store_chunk(uint32_t* __restrict__ out,
                                            const uint32_t* s_rows,
                                            int64_t b0, int64_t n_blocks,
                                            int n_groups, int g0, int cw,
                                            int lane) {
  const int64_t rows = n_blocks - b0 < 32 ? n_blocks - b0 : 32;
  if ((cw & 3) == 0 && (n_groups & 3) == 0) {
    // 16-byte units: 1 (cw 4) or 2 (cw 8) per row, 16-byte aligned in out
    const int sh = cw >> 3;
    for (int u = lane; u < 8 * cw; u += 32) {
      const int r = u >> sh;
      const int c = (u & sh) << 2;
      if (r < rows) {
        const uint32_t* s = s_rows + r * kRowWords + c;
        *reinterpret_cast<uint4*>(out + (b0 + r) * n_groups + g0 + c) =
            make_uint4(s[0], s[1], s[2], s[3]);
      }
    }
  } else {
    // u32 units (2x2, and sizes that are no multiple of 16 symbols)
    for (int f = lane; f < 32 * cw; f += 32) {
      const int r = cw == 1 ? f : f / cw;
      const int c = f - r * cw;
      if (r < rows) {
        out[(b0 + r) * n_groups + g0 + c] = s_rows[r * kRowWords + c];
      }
    }
  }
}

// Store a warp's staged chunk a byte at a time, for blocks of a size that is
// no multiple of 4, whose rows start at any byte: rows b0 .. b0+31 (those
// below n_blocks), cb bytes each (1..32) from symbol 4*g0, from s_rows. Lane
// f of the warp's rows*cb bytes walks them 32 at a time, its (row, column)
// stepped without a division per byte.
__device__ __forceinline__ void store_chunk_bytes(uint8_t* __restrict__ out,
                                                  const uint32_t* s_rows,
                                                  int64_t b0, int64_t n_blocks,
                                                  int num_steps, int g0, int cb,
                                                  int lane) {
  const int rows = n_blocks - b0 < 32 ? (int)(n_blocks - b0) : 32;
  const uint8_t* s = reinterpret_cast<const uint8_t*>(s_rows);
  uint8_t* base = out + b0 * num_steps + 4 * g0;
  const int dr = 32 / cb, dc = 32 - dr * cb;
  int r = lane / cb, c = lane - r * cb;
  while (r < rows) {
    base[(int64_t)r * num_steps + c] = s[r * (4 * kRowWords) + c];
    r += dr;
    c += dc;
    if (c >= cb) {
      c -= cb;
      ++r;
    }
  }
}

// MODE 0: no precoder; 1: 1-D delta over the whole block; 2: delta2d, 8x8
// blocks only (num_steps == 64: two groups per 8-pixel row). T2_SMEM as in
// decode_images.cu. TAIL: num_steps % 4 != 0, so the blocks end with a short
// group and go out a byte at a time. The sizes without a tail get kernels
// without that code: in one kernel for all sizes ptxas gave MODE 1 40
// registers for sm_90a, where it gives 32, and 256 threads of 40 registers
// fit 6 times in an SM's 65,536, so 4x4 and 8x8 would lose 2 of their 8
// resident CUDA blocks.
template <int MODE, bool T2_SMEM, bool TAIL>
__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const uint32_t* __restrict__ words, uint64_t last_word,
                     const uint32_t* __restrict__ offsets, int64_t n_blocks,
                     int num_steps, const int16_t* __restrict__ table,
                     uint32_t stage_bytes, uint8_t* __restrict__ out,
                     int32_t* __restrict__ end) {
  extern __shared__ __align__(128) int16_t s_tab[];
  __shared__ uint64_t bar;
  __shared__ uint32_t s_stage[kThreads * kRowWords];
  mht::stage_lut(table, stage_bytes, s_tab, &bar);
  const int16_t* t2 = (T2_SMEM ? s_tab : table) + (1 << mht::kK1);

  const int lane = threadIdx.x & 31;
  const int warp_first = threadIdx.x & ~31;
  const uint32_t* s_rows = s_stage + warp_first * kRowWords;
  uint32_t* s_row = s_stage + threadIdx.x * kRowWords;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int n_groups = (num_steps + 3) >> 2;
  const int tail = TAIL ? num_steps & 3 : 0;  // a short last group's symbols
#pragma unroll 1
  for (int64_t b0 = (int64_t)blockIdx.x * kThreads + warp_first; b0 < n_blocks;
       b0 += stride) {  // warp-uniform: the warp's blocks b0 .. b0+31
    const int64_t b = b0 + lane;
    const bool live = b < n_blocks;
    const uint32_t start = offsets[live ? b : n_blocks - 1];
    uint64_t pos = start;
    uint32_t prev = 0;      // 1-D delta accumulator, reset per block
    uint64_t prev_row = 0;  // delta2d: the reconstructed row above
#pragma unroll 1
    for (int g0 = 0; g0 < n_groups; g0 += kChunk) {
      const int cw = n_groups - g0 < kChunk ? n_groups - g0 : kChunk;
      if (MODE == 2) {  // n_groups == 16: cw == 8, four 8-pixel rows
#pragma unroll 1
        for (int j = 0; j < cw; j += 2) {
          uint32_t lo, hi;
          pos += mht::decode_group_lut<T2_SMEM, false>(
              words, last_word, pos, s_tab, t2, prev, lo);
          pos += mht::decode_group_lut<T2_SMEM, false>(
              words, last_word, pos, s_tab, t2, prev, hi);
          prev_row = mht::delta2d_row((g0 + j) >> 1,
                                      ((uint64_t)hi << 32) | lo, prev_row);
          s_row[j] = (uint32_t)prev_row;
          s_row[j + 1] = (uint32_t)(prev_row >> 32);
        }
      } else {
        // the short last group, when there is one, closes the last chunk
        const int full = tail && g0 + cw == n_groups ? cw - 1 : cw;
#pragma unroll 1
        for (int j = 0; j < full; ++j) {
          uint32_t packed;
          pos += mht::decode_group_lut<T2_SMEM, MODE == 1>(
              words, last_word, pos, s_tab, t2, prev, packed);
          s_row[j] = packed;
        }
        if (full < cw) {
          uint32_t packed;
          pos += mht::decode_tail_lut<T2_SMEM, MODE == 1>(
              words, last_word, pos, s_tab, t2, tail, prev, packed);
          s_row[full] = packed;
        }
      }
      __syncwarp();
      if (TAIL) {
        const int left = num_steps - 4 * g0;
        store_chunk_bytes(out, s_rows, b0, n_blocks, num_steps, g0,
                          left < 4 * kChunk ? left : 4 * kChunk, lane);
      } else {
        store_chunk(reinterpret_cast<uint32_t*>(out), s_rows, b0, n_blocks,
                    n_groups, g0, cw, lane);
      }
      __syncwarp();  // the rows are stored before the next chunk lands
    }
    if (live && end != nullptr) end[b] = mht::row_local_end(start, pos);
  }
}

struct Args {
  const uint32_t* words;
  uint64_t last_word;
  const uint32_t* offsets;
  int64_t n_blocks;
  int num_steps;
  int max_per_sm;
  const int16_t* table;
  uint32_t stage_bytes;
  uint8_t* out;
  int32_t* end;
  cudaStream_t stream;
};

template <int MODE, bool T2_SMEM, bool TAIL>
int run(const Args& a, bool shape_only, mht::GridShape* shape) {
  static mht::KernelCache cache;
  auto* kernel = decode_blocks_kernel<MODE, T2_SMEM, TAIL>;
  int sms = 0, per_sm = 0;
  const int err = mht::launch_facts(kernel, cache, a.stage_bytes, &sms,
                                    &per_sm);
  if (err) return err;
  // the persistent grid: the CUDA blocks that reside at once under the cap,
  // fewer when the batch needs fewer (whole warps: the tail warp's idle
  // lanes run too)
  shape->ctas_per_sm = per_sm < a.max_per_sm ? per_sm : a.max_per_sm;
  const int64_t need = ((a.n_blocks + 31) / 32 * 32 + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)shape->ctas_per_sm * sms;
  shape->grid = (int)(need < most ? need : most);
  shape->dyn_smem = (int)a.stage_bytes;
  if (shape_only) return mht::kernel_attributes(kernel, shape);
  kernel<<<shape->grid, kThreads, a.stage_bytes, a.stream>>>(
      a.words, a.last_word, a.offsets, a.n_blocks, a.num_steps, a.table,
      a.stage_bytes, a.out, a.end);
  return (int)cudaGetLastError();
}

template <int MODE, bool TAIL>
int dispatch(const Args& a, int t2_smem, bool shape_only,
             mht::GridShape* shape) {
  return t2_smem ? run<MODE, true, TAIL>(a, shape_only, shape)
                 : run<MODE, false, TAIL>(a, shape_only, shape);
}

int decode(const void* words, int64_t n_words, const void* offsets,
           int64_t n_blocks, int num_steps, const void* table,
           int64_t table_entries, int t2_smem, int mode, void* out, void* end,
           void* stream, bool shape_only, mht::GridShape* shape) {
  const uint32_t stage_bytes = mht::lut_stage_bytes(table_entries, t2_smem);
  if (n_words < 3 || n_blocks <= 0 || num_steps < 1 || num_steps > kMaxSteps ||
      mode < 0 || mode > 2 || (mode == 2 && num_steps != 64) ||
      stage_bytes == 0) {
    return (int)cudaErrorInvalidValue;
  }
  // resident threads such that their blocks' code words stay in L1: each
  // thread streams its own block, so at 16x16 (~140 bytes a block) 2048
  // threads per SM evict each other's lines before their next refill; past
  // kL1Bytes / kThreads = 512 bytes a block the cap is 1 CUDA block per SM
  const int64_t block_bytes = 4 * n_words / n_blocks + 1;
  const int64_t fit = kL1Bytes / (kThreads * block_bytes);
  const Args a{static_cast<const uint32_t*>(words),
               (uint64_t)(n_words - 3),
               static_cast<const uint32_t*>(offsets),
               n_blocks, num_steps, fit < 1 ? 1 : (int)(fit < 8 ? fit : 8),
               static_cast<const int16_t*>(table),
               stage_bytes,
               static_cast<uint8_t*>(out),
               static_cast<int32_t*>(end),
               static_cast<cudaStream_t>(stream)};
  const bool tail = num_steps & 3;  // mode 2 has num_steps 64
  if (mode == 0) {
    return tail ? dispatch<0, true>(a, t2_smem, shape_only, shape)
                : dispatch<0, false>(a, t2_smem, shape_only, shape);
  }
  if (mode == 1) {
    return tail ? dispatch<1, true>(a, t2_smem, shape_only, shape)
                : dispatch<1, false>(a, t2_smem, shape_only, shape);
  }
  return dispatch<2, false>(a, t2_smem, shape_only, shape);
}

}  // namespace

// Decode n_blocks blocks of num_steps symbols each into out, an (n_blocks,
// num_steps) uint8 buffer in the order of the offset index, aligned to 16
// bytes where num_steps is a multiple of 16, to 4 where of 4, else to any
// byte (ops/decode_cuda.py::store_bytes). words: n_words >= 3 big-endian u32
// code words; offsets: n_blocks u32 bit offsets; table, table_entries,
// t2_smem: the lookup table, as for mht_decode_images; num_steps: 1 to 65025
// (blocks of 1x1 to 255x255); mode: 0 none, 1 delta, 2 delta2d (num_steps ==
// 64 only); end: NULL, or n_blocks int32 for the row-local end bits. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mht_decode_blocks(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int num_steps, const void* table,
                                 int64_t table_entries, int t2_smem, int mode,
                                 void* out, void* end, void* stream) {
  mht::GridShape shape;
  return decode(words, n_words, offsets, n_blocks, num_steps, table,
                table_entries, t2_smem, mode, out, end, stream, false, &shape);
}

// As mht_decode_images_shape, for mht_decode_blocks over n_words code words
// (they set the occupancy cap).
extern "C" int mht_decode_blocks_shape(int64_t n_words, int64_t n_blocks,
                                       int num_steps, int64_t table_entries,
                                       int t2_smem, int mode, int* shape) {
  mht::GridShape s;
  const int err = decode(nullptr, n_words, nullptr, n_blocks, num_steps, nullptr,
                         table_entries, t2_smem, mode, nullptr, nullptr,
                         nullptr, true, &s);
  if (err) return err;
  const int v[6] = {s.ctas_per_sm, s.grid, s.dyn_smem, s.static_smem,
                    s.registers, s.local_bytes};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  return 0;
}
