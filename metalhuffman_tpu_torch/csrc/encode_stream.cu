// The hybrid canonical-Huffman encoder on Hopper, rows and merge in one:
// every block's codes packed MSB-first directly at the block's bit offset in
// the final stream, by two passes over the symbols.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/encode_pallas.py::
// make_encode_kernel, launched by encode_rows (encode_pallas.py:138), together
// with the host step that merges its rows into the stream (native
// mht_merge_rows, native/src/mht_codec.cpp:557). The TPU kernel can only pack
// each block into a padded row of its own, because Mosaic has no per-lane
// addressing (encode_pallas.py:21-24); a CUDA thread writes to any address,
// so the rows, their copy to the host and the merge go away. The stream is
// byte-identical to the host encoder's: the same codes, the same per-block
// offsets (complete blocks only), the partial last block packed after them.
//
// Pass 0 (count) writes each block's bit count; the caller takes their
// inclusive prefix sum (torch.cumsum, int64) and sizes a zeroed stream from
// the total. Pass 1 (pack) writes the codes at their offsets, and the u32
// offset of every complete block.
//
// What bounds it on the H100: the bytes of the function (symbols in, stream
// and offsets out, the 1 KB table), ~0.045 ms at 3.35 TB/s for the
// 30x2048x1536 batch; about 4 integer operations a symbol take a quarter of
// that. The count pass's second read of the symbols is this design's cost,
// not the function's work. The design keeps every transfer coalesced:
// - A warp takes 8 consecutive blocks (512 symbols): 4 lanes a block, 16
//   symbols a lane, read as one 16-byte load, so lane t reads bytes
//   16t..16t+15 and the warp one contiguous 512-byte run. A buffer that is
//   not 16-byte aligned (or the last, partial run) takes byte loads.
// - The 256-entry table, (left-justified 16-bit code << 16) | width, sits in
//   shared memory: the lanes look up 32 different symbols at once.
// - Count: each lane sums its 16 widths, two __shfl_xor_sync give the block.
// - Pack: a lane's run starts at its block's offset plus the counts of the
//   lanes before it in the block (a shuffle scan). It packs its <= 256 bits
//   in a 64-bit accumulator and ORs each 32-bit word into the warp's span in
//   shared memory: the bits from the warp's first offset, rounded down to a
//   word, to its end, at most 8 x 1024 + 31 bits. Only a run's first and last
//   word can be shared with a neighbouring lane (shared atomicOr); the words
//   between belong to the lane alone (plain stores). A run shorter than 32
//   bits (16 one-bit codes, or a lane of the partial block) has both ends in
//   one word; a run that ends on a word boundary leaves no partial word.
// - Then the warp stores its span as consecutive words, byte-swapped to the
//   stream's big-endian order. Only the span's first and last word can be
//   shared with a neighbouring warp: those go through a global atomicOr on
//   the zeroed stream, the words between are plain coalesced stores.
// - Both passes run on a persistent grid, as many 256-thread CUDA blocks as
//   stay resident: each stages the table once, then strides over the lanes
//   (count) or its warps over the groups of 8 blocks (pack). With one CUDA
//   block per 4 KB of symbols, the table's staging and barrier took most of
//   each block's life.
// A single pass with a decoupled look-back scan would save the second read
// of the symbols and the launch between the passes; it is not done here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per CUDA block; one table entry each
constexpr int kWarps = kThreads / 32;
constexpr int kBlockSymbols = 64;
constexpr int kLaneSymbols = 16;  // 4 lanes per block
constexpr int kWarpBlocks = 32 * kLaneSymbols / kBlockSymbols;  // 8
// a warp's span: 8 blocks of at most 64 16-bit codes, from a word boundary up
// to 31 bits before the warp's first bit
constexpr int kSpanWords = (kWarpBlocks * kBlockSymbols * 16 + 31) / 32 + 1;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Lane t's 16 symbols, bytes 16t..16t+15 of the n-byte buffer, as four
// little-endian words (symbol 4i+k in byte k of v[i]); returns how many of
// them lie inside the buffer (0..16).
template <bool VEC>
__device__ __forceinline__ int load_lane(const uint8_t* __restrict__ symbols,
                                         int64_t n, int64_t first,
                                         uint32_t v[4]) {
  if (VEC && first + kLaneSymbols <= n) {
    const uint4 p = *reinterpret_cast<const uint4*>(symbols + first);
    v[0] = p.x;
    v[1] = p.y;
    v[2] = p.z;
    v[3] = p.w;
    return kLaneSymbols;
  }
  const int valid = first >= n ? 0
                               : (int)(n - first < kLaneSymbols ? n - first
                                                                : kLaneSymbols);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = 0;
#pragma unroll
  for (int k = 0; k < kLaneSymbols; ++k)
    if (k < valid) v[k >> 2] |= (uint32_t)symbols[first + k] << (8 * (k & 3));
  return valid;
}

// The lane's 16 table entries (0 past the `valid` symbols) and its bit count.
__device__ __forceinline__ uint32_t lane_entries(const uint32_t v[4],
                                                 int valid,
                                                 const uint32_t* s_tab,
                                                 uint32_t e[kLaneSymbols]) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kLaneSymbols; ++k) {
    e[k] = k < valid ? s_tab[(v[k >> 2] >> (8 * (k & 3))) & 0xFF] : 0;
    bits += e[k] & 0xFF;
  }
  return bits;
}

// Pass 0: bits[b] = the bit count of block b (the last one partial when
// 64 does not divide n). A persistent grid: each CUDA block stages the table
// once, then its threads stride over the lanes.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ symbols, int64_t n, int64_t lanes,
             const uint32_t* __restrict__ table, uint32_t* __restrict__ bits) {
  __shared__ uint32_t s_tab[256];
  s_tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * kThreads;  // whole warps
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < lanes;
       t += stride) {
    const int64_t first = t * kLaneSymbols;
    uint32_t v[4], e[kLaneSymbols];
    const int valid = load_lane<VEC>(symbols, n, first, v);
    uint32_t sum = lane_entries(v, valid, s_tab, e);
    sum += __shfl_xor_sync(kFull, sum, 1);  // the 4 lanes of one block
    sum += __shfl_xor_sync(kFull, sum, 2);
    if ((threadIdx.x & 3) == 0 && first < n) bits[t >> 2] = sum;
  }
}

// Pass 1: the codes of every block at its bit offset, incl[b - 1] (0 for
// block 0), into the zeroed big-endian stream; offsets[b] for the n_full
// complete blocks. A persistent grid: each CUDA block stages the table
// once, then each warp strides over the groups of 8 blocks.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ symbols, int64_t n,
            const uint32_t* __restrict__ table,
            const int64_t* __restrict__ incl, int64_t n_blocks, int64_t n_full,
            uint32_t* __restrict__ stream, uint32_t* __restrict__ offsets) {
  __shared__ uint32_t s_tab[256];
  __shared__ uint32_t s_span[kWarps][kSpanWords];
  const int lane = threadIdx.x & 31;
  uint32_t* span = s_span[threadIdx.x >> 5];
  s_tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();

  const int64_t groups = (n_blocks + kWarpBlocks - 1) / kWarpBlocks;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < groups; g += (int64_t)gridDim.x * kWarps) {  // the same per warp
    for (int i = lane; i < kSpanWords; i += 32) span[i] = 0;
    __syncwarp();

    const int64_t wb0 = g * kWarpBlocks;  // the warp's first block
    const int64_t w_start = wb0 ? incl[wb0 - 1] : 0;
    const int64_t w_last =
        (wb0 + kWarpBlocks < n_blocks ? wb0 + kWarpBlocks : n_blocks) - 1;
    const int64_t w_end = incl[w_last];
    const int64_t base = w_start & ~(int64_t)31;  // bit of span word 0

    const int64_t t = g * 32 + lane;
    const int64_t first = t * kLaneSymbols;
    const int64_t b = t >> 2;
    uint32_t v[4], e[kLaneSymbols];
    const int valid = load_lane<VEC>(symbols, n, first, v);
    const uint32_t lbits = lane_entries(v, valid, s_tab, e);
    // exclusive scan of the lane counts over the 4 lanes of the block
    uint32_t x = lbits;
    uint32_t y = __shfl_up_sync(kFull, x, 1);
    if (lane & 3) x += y;
    y = __shfl_up_sync(kFull, x, 2);
    if (lane & 2) x += y;

    if (first < n) {
      const int64_t b_start = b ? incl[b - 1] : 0;
      if ((lane & 3) == 0 && b < n_full) offsets[b] = (uint32_t)b_start;
      if (lbits) {
        const int r = (int)(b_start + (x - lbits) - base);  // run's first bit
        const int fw = r >> 5;
        const int lw = (r + (int)lbits - 1) >> 5;
        uint64_t acc = 0;  // its low `pending` bits are not stored yet
        int pending = r & 31;  // the span bits before the run, zeros of acc
        int word = fw;
#pragma unroll
        for (int k = 0; k < kLaneSymbols; ++k) {
          const uint32_t w = e[k] & 0xFF;  // 0..16; 0 past the buffer's end
          // the code right-justified: the top w bits of the 16-bit code
          acc = (acc << w) | ((e[k] >> 16) >> (16 - w));
          pending += w;
          if (pending >= 32) {
            pending -= 32;
            const uint32_t out = (uint32_t)(acc >> pending);
            if (word == fw || word == lw) {
              atomicOr(&span[word], out);
            } else {
              span[word] = out;
            }
            ++word;
          }
        }
        if (pending > 0) {  // the run's last word (word == lw), bits at the top
          atomicOr(&span[word], (uint32_t)(acc << (32 - pending)));
        }
      }
    }
    __syncwarp();

    if (w_end > w_start) {
      const int64_t w0 = base >> 5;  // the stream word of span word 0
      const int nw = (int)(((w_end - 1) >> 5) - w0 + 1);
      for (int i = lane; i < nw; i += 32) {
        const uint32_t v = __byte_perm(span[i], 0, 0x0123);  // to big-endian
        if (i == 0 || i == nw - 1) {
          atomicOr(&stream[w0 + i], v);
        } else {
          stream[w0 + i] = v;
        }
      }
    }
    __syncwarp();  // the span is read before the next group zeroes it
  }
}

// CUDA blocks for a persistent launch of `kernel` over `work` CUDA blocks'
// worth of threads: as many as stay resident on the current device, or
// fewer. Returns a CUDA error (0 on success).
template <typename Kernel>
int persistent_grid(Kernel kernel, int64_t work, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(work < resident ? work : resident);
  return 0;
}

}  // namespace

// Encode the n symbols (device bytes, any alignment) under table (256 device
// u32, (left-justified code << 16) | width, widths 0..16) in blocks of 64,
// the last one partial when 64 does not divide n.
// pass 0: bits (ceil(n/64) device u32) <- each block's bit count.
// pass 1: incl (ceil(n/64) device int64) is the inclusive prefix sum of the
//   counts; stream (device u32, zeroed, at least incl[last] bits) <- the
//   codes MSB-first, each word big-endian in memory; offsets (n/64 device
//   u32) <- each complete block's bit offset.
// Launches on `stream_` and returns cudaGetLastError() (0 on success).
extern "C" int mht_encode_stream(const void* symbols, int64_t n,
                                 const void* table, void* bits,
                                 const void* incl, void* stream, void* offsets,
                                 int pass, void* stream_) {
  if (n <= 0 || (pass != 0 && pass != 1)) return (int)cudaErrorInvalidValue;
  const auto* sym = static_cast<const uint8_t*>(symbols);
  const auto* tab = static_cast<const uint32_t*>(table);
  const int64_t n_blocks = (n + kBlockSymbols - 1) / kBlockSymbols;
  // whole warps of lanes: every lane of a warp takes part in its shuffles
  const int64_t lanes = (n_blocks + kWarpBlocks - 1) / kWarpBlocks * 32;
  const int64_t work = (lanes + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const bool vec = reinterpret_cast<uintptr_t>(sym) % 16 == 0;
  unsigned grid = 0;
  int err = 0;
  if (pass == 0) {
    auto* out = static_cast<uint32_t*>(bits);
    auto kernel = vec ? count_kernel<true> : count_kernel<false>;
    err = persistent_grid(kernel, work, &grid);
    if (err) return err;
    kernel<<<grid, kThreads, 0, st>>>(sym, n, lanes, tab, out);
  } else {
    const auto* in = static_cast<const int64_t*>(incl);
    auto* words = static_cast<uint32_t*>(stream);
    auto* offs = static_cast<uint32_t*>(offsets);
    auto kernel = vec ? pack_kernel<true> : pack_kernel<false>;
    err = persistent_grid(kernel, work, &grid);
    if (err) return err;
    kernel<<<grid, kThreads, 0, st>>>(sym, n, tab, in, n_blocks,
                                      n / kBlockSymbols, words, offs);
  }
  return (int)cudaGetLastError();
}
