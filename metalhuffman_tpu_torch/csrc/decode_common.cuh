// The canonical-Huffman decode steps shared by the port's decode kernels.
//
// Counterpart of the per-group body of metalhuffman_tpu/ops/decode_pallas.py::
// _make_kernel (`outer`), which serves both TPU kernels, decode_tiles_images
// and decode_tiles: refill a 64-bit window at the block's bit position, then
// decode 4 symbols from it. Two forms of the symbol step live here:
//
// - decode_group_lut, B1's step (decode_images.cu): one lookup in a two-level
//   table that tabulates the interval decode below on every 16-bit window
//   (ops/decode_cuda.py::lookup_entries), staged once per CUDA block by
//   stage_lut. Its symbol loop, decode_window_lut, is apart from the refill
//   so that B2 (decode_blocks.cu, from its read-ahead buffer) and the probes
//   of B1 (decode_strips.cu, ablate_decode.cu's b1 family) feed it windows
//   read another way, and the kernels cannot drift. decode_tail_lut is that
//   loop over a block's last 1-3 symbols, where the block's size is no
//   multiple of 4 (decode_blocks.cu only, which reads its windows ahead: the
//   TPU kernel refuses such sizes, the JAX package's XLA decode takes them);
// - decode_group, the canonical-interval arithmetic the TPU kernel runs (15
//   compares per symbol): the plain versions' arithmetic, and the body of
//   ablate_decode.cu's first five variants, which keep the record of B1
//   before its lookup-table redesign.
//
// Both give the same width and symbol on every window, so the same bytes and
// end bits on any stream, malformed ones included.

#pragma once

#include <atomic>
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
// It reads words pos>>5 .. (pos>>5)+2. The caller pads the stream with two
// words so a well-formed block never needs more: every symbol takes at least
// one bit, so any group, a block's short last group of 1-3 symbols included,
// starts at or before total_bits - 1, inside the unpadded stream's last word,
// and reads at most the two pad words past it. The clamp to last_word =
// n_words - 3 keeps a malformed offset or a desynchronised corrupt stream
// inside the buffer.
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

// block_origin for a batch of fewer than 2^32 blocks, in 32-bit arithmetic:
// a 64-bit division is a long subroutine, and block_origin takes two per
// block.
__device__ __forceinline__ uint8_t* block_origin32(uint8_t* out, uint32_t b,
                                                   uint32_t bh, uint32_t bw) {
  const uint32_t per_frame = bh * bw;
  const uint32_t f = b / per_frame;
  const uint32_t r = b - f * per_frame;
  const uint32_t by = r / bw;
  const uint32_t bx = r - by * bw;
  return out + ((int64_t)(f * bh + by) * 8) * ((int64_t)bw * 8) + bx * 8;
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

// ---- the lookup-table step ---------------------------------------------------
//
// The table (ops/decode_cuda.py::lookup_entries) is u16 entries, T1 then T2 in
// one buffer. T1 has 2^kK1 entries, indexed by the window's top kK1 bits; each
// secondary table of T2 has 2^kK2, indexed by the rest. An entry is width *
// 256 + symbol with width 1..16, or in T1, kEscape | t, which sends the window
// to secondary table t. Every 16-bit window resolves to the interval decode's
// (width, symbol), so no entry has width 0 and no window needs a special case,
// whatever the stream holds.

constexpr int kK1 = 11;  // T1's bits (ops/decode_cuda.py::LUT_K1): 4 KB
constexpr int kK2 = 16 - kK1;
constexpr uint32_t kEscape = 0x8000;
// T2 is staged into shared memory with T1 up to this many table bytes, and
// read through L1 above (ops/decode_cuda.py::T2_SMEM_MAX_BYTES): at 64 KB a
// 256-thread CUDA block of either kernel still fits 3 times on an SM, past it
// occupancy falls to 2 and then 1 (a malformed table can need 132 KB). A
// complete code needs at most 12 KB: the L1 path serves the one-symbol code
// and malformed ones.
constexpr uint32_t kT2SmemMaxBytes = 64 * 1024;
constexpr uint32_t kBulkChunk = 16 * 1024;  // bytes per bulk copy instruction

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `bytes` (a multiple of 16, 16-byte aligned at both ends) of the table
// from global into shared memory with the bulk-copy engine, completing on the
// mbarrier `bar`; every thread of the CUDA block returns once it has landed.
// Called once per CUDA block, by all its threads.
__device__ __forceinline__ void stage_lut(const int16_t* __restrict__ src,
                                          uint32_t bytes, int16_t* dst,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(bytes) : "memory");
    for (uint32_t off = 0; off < bytes; off += kBulkChunk) {
      const uint32_t n = bytes - off < kBulkChunk ? bytes - off : kBulkChunk;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          ::"r"(smem_addr(reinterpret_cast<const char*>(dst) + off)),
          "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
          : "memory");
    }
  }
  uint32_t done = 0;
  while (!done) {  // phase 0 completes when the bytes have landed
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b) : "memory");
  }
}

// Decode N (4, or 1-3 for a block's last group) symbols from `win`, the
// 64-bit window left-justified at their first bit, through the lookup table:
// T1 in shared memory (s_t1), T2 in shared memory (T2_SMEM) or global memory
// read through L1. Returns the bits they took; `packed` gets them
// little-endian (symbol k in byte k, the bytes past N zero), with DELTA the
// running sum `prev` of the 1-D delta, carried across calls. The entries are
// read as signed 16-bit values, so the escape bit is the sign and its test
// one compare (the unsigned test took an extra instruction per symbol in
// ptxas's code).
template <bool T2_SMEM, bool DELTA, int N = 4>
__device__ __forceinline__ uint32_t decode_window_lut(
    uint64_t win, const int16_t* s_t1, const int16_t* __restrict__ t2,
    uint32_t& prev, uint32_t& packed) {
  uint32_t t = 0;  // bits consumed in this group, <= 48 before symbol 3
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t window = (uint32_t)((win << t) >> 48);
    int32_t e = s_t1[window >> kK2];
    if (e < 0) {  // kEscape | secondary table
      const uint32_t i = (((uint32_t)e & (kEscape - 1)) << kK2) |
                         (window & ((1u << kK2) - 1));
      e = T2_SMEM ? t2[i] : __ldg(t2 + i);
    }
    uint32_t sym = (uint32_t)e & 0xFF;
    if (DELTA) {
      prev = (prev + sym) & 0xFF;
      sym = prev;
    }
    out |= sym << (8 * k);
    t += (uint32_t)e >> 8;
  }
  packed = out;
  return t;
}

// Decode the N (default 4) symbols that start at absolute bit `pos`, as
// decode_group does, through the lookup table: the refill and
// decode_window_lut.
template <bool T2_SMEM, bool DELTA, int N = 4>
__device__ __forceinline__ uint32_t decode_group_lut(
    const uint32_t* __restrict__ words, uint64_t last_word, uint64_t pos,
    const int16_t* s_t1, const int16_t* __restrict__ t2, uint32_t& prev,
    uint32_t& packed) {
  return decode_window_lut<T2_SMEM, DELTA, N>(refill(words, last_word, pos),
                                              s_t1, t2, prev, packed);
}

// A block's last group when its size is no multiple of 4: decode_window_lut
// over just its r = 1, 2 or 3 symbols of `win`, so the bits taken are their
// widths alone, `prev` carries through them alone and the end bit is the
// block's own. (Decoding 4 and dropping the rest would add the width of a
// symbol past the block.) r is warp-uniform: every lane's block has one size.
template <bool T2_SMEM, bool DELTA>
__device__ __forceinline__ uint32_t decode_tail_lut(
    uint64_t win, const int16_t* s_t1, const int16_t* __restrict__ t2, int r,
    uint32_t& prev, uint32_t& packed) {
  if (r == 1) {
    return decode_window_lut<T2_SMEM, DELTA, 1>(win, s_t1, t2, prev, packed);
  }
  if (r == 2) {
    return decode_window_lut<T2_SMEM, DELTA, 2>(win, s_t1, t2, prev, packed);
  }
  return decode_window_lut<T2_SMEM, DELTA, 3>(win, s_t1, t2, prev, packed);
}

// ---- launches ------------------------------------------------------------------

// What a launch of a decode kernel looks like, for the wrappers' report
// (ops/decode_cuda.py::launch_shape).
struct GridShape {
  int ctas_per_sm;   // resident CUDA blocks per SM at this shared memory
  int grid;          // CUDA blocks launched
  int dyn_smem;      // dynamic shared memory per CUDA block (the table)
  int static_smem;   // static shared memory per CUDA block
  int registers;     // per thread, as ptxas allotted them
  int local_bytes;   // per thread: spills and stack
};

constexpr int kMaxDevices = 64;

// One kernel's launch facts, per device, so a launch costs no runtime calls
// beyond the launch itself: whether it has opted in to the table's dynamic
// shared memory above 48 KB, and its occupancy at the last table size, packed
// as (dyn_smem + 1) << 8 | CUDA blocks per SM in one word (0: not known), so
// that concurrent launches never pair one size with another's occupancy.
// Static storage only: it relies on zero initialisation.
struct KernelCache {
  std::atomic<int> opted[kMaxDevices];
  std::atomic<int64_t> occupancy[kMaxDevices];
};

// The current device's SM count and `kernel`'s resident 256-thread CUDA
// blocks per SM at `dyn_smem` bytes of dynamic shared memory, after opting
// the kernel in to `max_dyn` bytes of it (the table's kT2SmemMaxBytes unless
// the kernel keeps more there) on that device. Returns a CUDA error (0 on
// success).
template <typename Kernel>
int launch_facts(Kernel kernel, KernelCache& cache, uint32_t dyn_smem,
                 int* sms, int* per_sm, uint32_t max_dyn = kT2SmemMaxBytes) {
  static std::atomic<int> sm_count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev].load() == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev].store(n);
  }
  if (!cache.opted[dev].load()) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_dyn);
    if (err != cudaSuccess) return (int)err;
    cache.opted[dev].store(1);
  }
  int64_t occ = cache.occupancy[dev].load();
  if (occ >> 8 != (int64_t)dyn_smem + 1) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        dyn_smem);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    occ = ((int64_t)dyn_smem + 1) << 8 | n;
    cache.occupancy[dev].store(occ);
  }
  *sms = sm_count[dev].load();
  *per_sm = (int)(occ & 0xFF);
  return 0;
}

// The kernel's attributes as ptxas left them, for the report.
template <typename Kernel>
int kernel_attributes(Kernel kernel, GridShape* shape) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  shape->static_smem = (int)attr.sharedSizeBytes;
  shape->registers = attr.numRegs;
  shape->local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// The table's launch parameters: the bytes stage_lut copies (the whole table
// when T2 is in shared memory, else T1), or 0 when the table is malformed.
__host__ inline uint32_t lut_stage_bytes(int64_t entries, int t2_smem) {
  const int64_t t1 = (int64_t)1 << kK1;
  const int64_t per_t2 = (int64_t)1 << kK2;
  if (entries < t1 || (entries - t1) % per_t2 || (entries - t1) / per_t2 > t1) {
    return 0;
  }
  const int64_t bytes = 2 * (t2_smem ? entries : t1);
  if (t2_smem && bytes > (int64_t)kT2SmemMaxBytes) return 0;
  return (uint32_t)bytes;
}

}  // namespace mht
