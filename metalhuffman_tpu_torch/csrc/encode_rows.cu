// Stage 1 of the hybrid canonical-Huffman encoder on Hopper: pack each block
// of 64 symbols into a zero-padded MSB-first word row and its bit count.
//
// Replaces the TPU kernel metalhuffman_tpu/ops/encode_pallas.py::
// make_encode_kernel, launched by encode_rows (encode_pallas.py:133-155). It
// computes the same words: block b's canonical codes concatenated MSB-first
// into words 0..wmax-1 of row b, zero-padded, and the block's bit count in
// word wmax. The host merges the rows into the stream (native mht_merge_rows).
//
// Design: one CUDA thread per block, 256 threads per CUDA block, a 64-bit
// accumulator that takes one code at a time and stores each 32-bit word of the
// row as it fills. The TPU kernel's 4-symbol chunks, its one-hot deposit over
// a ranged band of words (used_width_band) and the (8,128) pair tables and
// tile staging exist there only because Mosaic has no per-lane addressing
// (encode_pallas.py:21-24); a thread here addresses its own row. The table is
// one u32 per symbol, (left-justified 16-bit code << 16) | width, staged into
// shared memory once per CUDA block: each thread of a warp looks up its own
// symbol, and 32 different addresses in constant memory would serialize.
//
// What bounds it on the H100: the bytes (64 symbol bytes in and 4*(wmax+1)
// row bytes out per block; 206 MB at most for the 30x2048x1536 batch, ~0.06 ms
// at 3.35 TB/s), far above the ~4 integer operations a symbol needs. This
// simple form does not reach them: a warp's row stores land 4*(wmax+1) bytes
// apart, one sector each, and its symbol loads 64 bytes apart. Later work:
// staging rows and symbols through shared memory for coalesced transfers, or
// compacting the rows on the device so the host merge and most of the
// device-to-host copy go away.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per CUDA block; one table entry each
constexpr int kBlockSymbols = 64;

// VEC: the symbol buffer is 16-byte aligned, so each thread reads its 64
// bytes as four 16-byte loads; otherwise byte by byte.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
encode_rows_kernel(const uint8_t* __restrict__ symbols, int64_t n_blocks,
                   const uint32_t* __restrict__ table, int wmax,
                   uint32_t* __restrict__ rows) {
  __shared__ uint32_t s_tab[256];
  s_tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const uint8_t* src = symbols + b * kBlockSymbols;
  uint32_t* row = rows + b * (int64_t)(wmax + 1);

  uint64_t acc = 0;  // its low `pending` bits are not stored yet, MSB first
  int pending = 0;   // < 32 between symbols, so acc never holds over 47 bits
  int word = 0;      // the next row word to store
  uint32_t total = 0;
#pragma unroll
  for (int q = 0; q < kBlockSymbols / 16; ++q) {
    uint32_t v[4];  // 16 symbols, little-endian: symbol 4i+k in byte k of v[i]
    if (VEC) {
      const uint4 p = reinterpret_cast<const uint4*>(src)[q];
      v[0] = p.x;
      v[1] = p.y;
      v[2] = p.z;
      v[3] = p.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* s = src + 16 * q + 4 * i;
        v[i] = s[0] | (uint32_t)s[1] << 8 | (uint32_t)s[2] << 16 |
               (uint32_t)s[3] << 24;
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t e = s_tab[(v[k >> 2] >> (8 * (k & 3))) & 0xFF];
      const uint32_t w = e & 0xFF;  // 0..16; 0 for a symbol the table lacks
      // the code right-justified: the top w bits of the 16-bit code (a shift
      // by 16 - w <= 16 of a 32-bit value, always defined)
      acc = (acc << w) | ((e >> 16) >> (16 - w));
      pending += w;
      total += w;
      if (pending >= 32) {
        pending -= 32;
        if (word < wmax) row[word] = (uint32_t)(acc >> pending);
        ++word;
      }
    }
  }
  if (pending > 0) {  // 1..31 bits left: shift them to the top of the word
    if (word < wmax) row[word] = (uint32_t)(acc << (32 - pending));
    ++word;
  }
  for (; word < wmax; ++word) row[word] = 0;
  row[wmax] = total;
}

}  // namespace

// Pack n_blocks blocks of 64 symbols. symbols: n_blocks*64 device bytes,
// block-major; table: 256 device u32, (code << 16) | width with left-justified
// 16-bit codes and widths 0..16; rows: n_blocks*(wmax+1) device u32, row b
// holding block b's bits in words 0..wmax-1 (bits past 32*wmax are dropped)
// and its bit count in word wmax. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int mht_encode_rows(const void* symbols, int64_t n_blocks,
                               const void* table, int wmax, void* rows,
                               void* stream) {
  if (n_blocks <= 0 || wmax < 1) return (int)cudaErrorInvalidValue;
  const auto* sym = static_cast<const uint8_t*>(symbols);
  const auto* tab = static_cast<const uint32_t*>(table);
  auto* out = static_cast<uint32_t*>(rows);
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(sym) % 16 == 0) {
    encode_rows_kernel<true><<<grid, kThreads, 0, st>>>(sym, n_blocks, tab,
                                                        wmax, out);
  } else {
    encode_rows_kernel<false><<<grid, kThreads, 0, st>>>(sym, n_blocks, tab,
                                                         wmax, out);
  }
  return (int)cudaGetLastError();
}
