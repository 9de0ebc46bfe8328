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
// since a thread reads only its own offset. The symbol step, the lookup table
// and its staging are the image kernel's (decode_images.cu,
// decode_common.cuh). A CUDA block stages the table once and walks its
// blocks in a grid-stride loop by warp (a warp takes 32 consecutive
// blocks): one pass where the grid has a thread per block, as it has when
// the lanes read ahead, several where it is persistent, as many CUDA blocks
// as reside on the card at once, as it is where they refill through L1. A
// 255x255 block can hold about a million bits; a window still reads at most
// words (pos>>5)+2, so the two pad words of ops/decode_cuda.prepare_stream
// hold for every block size.
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
// sectors, at 4x4 the warp's rows are one contiguous run; written as one
// st.global.v4, since ptxas made four 4-byte stores of a uint4 assignment),
// u32 where it is 2 mod 4 (2x2, 6x6), and single bytes where it is odd, so a
// row starts at any byte: a lane per byte, so a chunk of 32 bytes a row goes
// out as one row per instruction, and a block of up to 32 symbols puts the
// warp's rows out as one contiguous run. Lanes past the last block decode
// the last block again and store nothing, so the warp stays converged for
// __syncwarp.
//
// The feed: each thread streams its own block's code words, in one of two
// ways chosen per launch from the stream's mean bytes a block (no setting),
// each at the residency its registers allow:
// - from kAheadMinBytes (64) up, read ahead (Feed, below): a 16-byte load a
//   128 bits into registers, three units deep, so no group waits on a load
//   and the code needs no room in L1 (4 CUDA blocks of 256 an SM at 53
//   registers: 4 ran faster than 5 at 48, and a thread per block than the
//   persistent grid or one sized to whole rounds);
// - below, B1's refill (mht::refill: three word loads through L1 a group;
//   8 CUDA blocks an SM at 32 registers), where a 128-byte line serves
//   several lanes: from 1x1 to 8x8 it runs faster than the read-ahead.
// The refill once served every size, with the CUDA blocks an SM capped so
// that the lanes' lines stayed in L1: 3 at 16x16, where caps 2 and 4 to 8
// ran slower as the lines evicted each other, and 1 from 512 bytes a block.
// The read-ahead took the cap's place (PERF.md).
//
// What bounds it on the H100 (read from the timings and the SASS: no
// profiler runs on the card's machine): the load/store unit's instructions,
// not bytes. A group issues 4-8 shared-memory lookups of its symbol step; the refill adds
// three L1 loads a group, the read-ahead one 16-byte load every ~7 groups at
// 16x16, and the staged stores one instruction a lane and chunk, where
// ptxas's four were. That took B2 at 16x16 from 0.2533 to 0.1954 ms queued
// on the bridge clip, 23 % of its 0.0453 ms byte bound (PERF.md); the
// lookups and the staging are what is left. 368,640 one-block chains for a
// 2048x1536 batch of 30 frames are 2.7 waves of the 4 CUDA blocks an SM,
// and at 32x32 the batch's 92,160 chains of 1024 symbols fill 2.7 CUDA
// blocks an SM once: the tail of one chain per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::kThreads;

constexpr int kChunk = 8;            // groups staged per row at a time
// mean code bytes a block from which the lanes read their blocks ahead
// (ops/decode_cuda.py::AHEAD_MIN_BYTES)
constexpr int64_t kAheadMinBytes = 64;
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
        // one 16-byte store (of a uint4 assignment ptxas makes four 4-byte
        // stores, each sector then taking four writes)
        asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(
                         out + (b0 + r) * n_groups + g0 + c),
                     "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3])
                     : "memory");
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

// The read-ahead feed: a lane's block bits in registers, three 16-byte units
// of the word stream in a row (cur, words c0..c3; nxt, n0..n3; far, f0..f3),
// each code word loaded once. A group's 64-bit window starts at bit s of cur
// (s < 128) and is cut from c0..n1 by two funnel shifts; once s passes cur,
// nxt becomes cur, far nxt, and the unit after them is requested into far.
// No window reads far, so a load waits for no group but one that rotates a
// group or more later: a warp waits on a register for every lane, and its
// lanes rotate in different groups, so a unit loaded into a register the
// windows read would hold up the warp's next group. Unit u of `units` (the
// words' 16-byte aligned base, `mis` words before them) holds words 4u - mis
// .. 4u - mis + 3. A lane whose units would leave the words (before word 0,
// or past the two pad words: last_unit is the last unit inside them) takes
// mht::refill at its bit position `pos` from then on, through L1: it clamps
// a malformed position as it always did, so both give every stream the same
// bytes and end bits. While a lane reads ahead, its bit position is (4u -
// mis) * 32 + s, and `pos` is left behind.
struct Feed {
  uint32_t c0, c1, c2, c3, n0, n1, n2, n3, f0, f1, f2, f3;
  uint32_t s;   // the window's first bit in cur
  uint32_t u;   // cur's unit
  bool ahead;   // false: this lane refills through L1 at pos
};

__device__ __forceinline__ void load_unit(const uint4* __restrict__ units,
                                          uint32_t u, uint32_t& x, uint32_t& y,
                                          uint32_t& z, uint32_t& w) {
  asm("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
      : "l"(units + u));
}

template <bool AHEAD>
__device__ __forceinline__ void feed_start(Feed& f,
                                           const uint4* __restrict__ units,
                                           uint32_t mis, uint32_t last_unit,
                                           uint64_t pos) {
  const uint64_t w = (pos >> 5) + mis;
  const uint64_t u = w >> 2;
  f.s = (uint32_t)((w & 3) << 5 | (pos & 31));
  f.u = (uint32_t)u;
  // units u .. u + 2 inside the words
  f.ahead = AHEAD && 4 * u >= mis && u + 2 <= last_unit;
  if (f.ahead) {
    load_unit(units, f.u, f.c0, f.c1, f.c2, f.c3);
    load_unit(units, f.u + 1, f.n0, f.n1, f.n2, f.n3);
    load_unit(units, f.u + 2, f.f0, f.f1, f.f2, f.f3);
  }
}

// The lane's bit position while it reads ahead.
__device__ __forceinline__ uint64_t feed_pos(const Feed& f, uint32_t mis) {
  return ((uint64_t)(4 * f.u - mis) << 5) + f.s;
}

// The 64-bit window of the lane's stream left-justified at its bit position:
// mht::refill's window.
__device__ __forceinline__ uint64_t feed_window(
    const Feed& f, const uint32_t* __restrict__ words, uint64_t last_word,
    uint64_t pos) {
  if (!f.ahead) return mht::refill(words, last_word, pos);
  // words s>>5 .. (s>>5)+2 of c0..n1, then bits s&31 .. of them
  const bool half = f.s & 64, odd = f.s & 32;
  const uint32_t a0 = half ? f.c2 : f.c0, a1 = half ? f.c3 : f.c1;
  const uint32_t a2 = half ? f.n0 : f.c2, a3 = half ? f.n1 : f.c3;
  const uint32_t x = odd ? a1 : a0, y = odd ? a2 : a1, z = odd ? a3 : a2;
  const uint32_t hi = __funnelshift_l(y, x, f.s);  // shifts by s & 31
  const uint32_t lo = __funnelshift_l(z, y, f.s);
  return (uint64_t)hi << 32 | lo;
}

// Count off the t bits a group took (t <= 64, so s stays under 192).
__device__ __forceinline__ void feed_advance(Feed& f,
                                             const uint4* __restrict__ units,
                                             uint32_t mis, uint32_t last_unit,
                                             uint64_t& pos, uint32_t t) {
  if (!f.ahead) {
    pos += t;
    return;
  }
  f.s += t;
  if (f.s >= 128) {
    f.s -= 128;
    f.c0 = f.n0;
    f.c1 = f.n1;
    f.c2 = f.n2;
    f.c3 = f.n3;
    f.n0 = f.f0;
    f.n1 = f.f1;
    f.n2 = f.f2;
    f.n3 = f.f3;
    ++f.u;
    if (f.u + 2 <= last_unit) {
      load_unit(units, f.u + 2, f.f0, f.f1, f.f2, f.f3);
    } else {
      f.ahead = false;
      pos = feed_pos(f, mis);
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
// resident CUDA blocks. AHEAD: the read-ahead feed, else the refill through
// L1 alone (the feed's code folds away).
template <int MODE, bool T2_SMEM, bool TAIL, bool AHEAD>
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

  // the words' 16-byte units: the base at or before words[0], and the last
  // unit that ends at or before words[last_word + 2]
  const uint32_t mis = (uint32_t)(reinterpret_cast<uintptr_t>(words) >> 2) & 3;
  const uint4* units = reinterpret_cast<const uint4*>(words - mis);
  const uint64_t lu = (last_word + mis + 3) >> 2;  // one past the last unit
  const uint32_t last_unit = lu == 0 ? 0 : (uint32_t)(lu - 1);

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
    Feed f;
    feed_start<AHEAD>(f, units, mis, last_unit, pos);
    uint32_t prev = 0;      // 1-D delta accumulator, reset per block
    uint64_t prev_row = 0;  // delta2d: the reconstructed row above
#pragma unroll 1
    for (int g0 = 0; g0 < n_groups; g0 += kChunk) {
      const int cw = n_groups - g0 < kChunk ? n_groups - g0 : kChunk;
      if (MODE == 2) {  // n_groups == 16: cw == 8, four 8-pixel rows
#pragma unroll 1
        for (int j = 0; j < cw; j += 2) {
          uint32_t lo, hi;
          feed_advance(f, units, mis, last_unit, pos,
                       mht::decode_window_lut<T2_SMEM, false>(
                           feed_window(f, words, last_word, pos), s_tab, t2,
                           prev, lo));
          feed_advance(f, units, mis, last_unit, pos,
                       mht::decode_window_lut<T2_SMEM, false>(
                           feed_window(f, words, last_word, pos), s_tab, t2,
                           prev, hi));
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
          feed_advance(f, units, mis, last_unit, pos,
                       mht::decode_window_lut<T2_SMEM, MODE == 1>(
                           feed_window(f, words, last_word, pos), s_tab, t2,
                           prev, packed));
          s_row[j] = packed;
        }
        if (full < cw) {  // the block's last group: nothing to read ahead
          uint32_t packed;
          const uint32_t t = mht::decode_tail_lut<T2_SMEM, MODE == 1>(
              feed_window(f, words, last_word, pos), s_tab, t2, tail, prev,
              packed);
          if (f.ahead) {
            f.s += t;
          } else {
            pos += t;
          }
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
    if (f.ahead) pos = feed_pos(f, mis);
    if (live && end != nullptr) end[b] = mht::row_local_end(start, pos);
  }
}

struct Args {
  const uint32_t* words;
  uint64_t last_word;
  const uint32_t* offsets;
  int64_t n_blocks;
  int num_steps;
  const int16_t* table;
  uint32_t stage_bytes;
  uint8_t* out;
  int32_t* end;
  cudaStream_t stream;
};

template <int MODE, bool T2_SMEM, bool TAIL, bool AHEAD>
int run(const Args& a, bool shape_only, mht::GridShape* shape) {
  static mht::KernelCache cache;
  auto* kernel = decode_blocks_kernel<MODE, T2_SMEM, TAIL, AHEAD>;
  int sms = 0, per_sm = 0;
  const int err = mht::launch_facts(kernel, cache, a.stage_bytes, &sms,
                                    &per_sm);
  if (err) return err;
  // a thread per block (whole warps: the tail warp's idle lanes run too);
  // where the lanes refill through L1, the persistent grid of the CUDA
  // blocks that reside at once, fewer when the batch needs fewer
  shape->ctas_per_sm = per_sm;
  const int64_t need = ((a.n_blocks + 31) / 32 * 32 + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)shape->ctas_per_sm * sms;
  shape->grid = (int)(AHEAD || need < most ? need : most);
  shape->dyn_smem = (int)a.stage_bytes;
  if (shape_only) return mht::kernel_attributes(kernel, shape);
  kernel<<<shape->grid, kThreads, a.stage_bytes, a.stream>>>(
      a.words, a.last_word, a.offsets, a.n_blocks, a.num_steps, a.table,
      a.stage_bytes, a.out, a.end);
  return (int)cudaGetLastError();
}

template <int MODE, bool TAIL>
int dispatch(const Args& a, int t2_smem, bool ahead, bool shape_only,
             mht::GridShape* shape) {
  if (ahead) {
    return t2_smem ? run<MODE, true, TAIL, true>(a, shape_only, shape)
                   : run<MODE, false, TAIL, true>(a, shape_only, shape);
  }
  return t2_smem ? run<MODE, true, TAIL, false>(a, shape_only, shape)
                 : run<MODE, false, TAIL, false>(a, shape_only, shape);
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
  // the feed, from the stream's mean bytes a block
  const bool ahead = 4 * n_words / n_blocks + 1 >= kAheadMinBytes;
  const Args a{static_cast<const uint32_t*>(words),
               (uint64_t)(n_words - 3),
               static_cast<const uint32_t*>(offsets),
               n_blocks, num_steps,
               static_cast<const int16_t*>(table),
               stage_bytes,
               static_cast<uint8_t*>(out),
               static_cast<int32_t*>(end),
               static_cast<cudaStream_t>(stream)};
  const bool tail = num_steps & 3;  // mode 2 has num_steps 64
  if (mode == 0) {
    return tail ? dispatch<0, true>(a, t2_smem, ahead, shape_only, shape)
                : dispatch<0, false>(a, t2_smem, ahead, shape_only, shape);
  }
  if (mode == 1) {
    return tail ? dispatch<1, true>(a, t2_smem, ahead, shape_only, shape)
                : dispatch<1, false>(a, t2_smem, ahead, shape_only, shape);
  }
  return dispatch<2, false>(a, t2_smem, ahead, shape_only, shape);
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
// (they set the feed).
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
