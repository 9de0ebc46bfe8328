// The per-frame CRC-32 of a range request on Hopper: one launch hashes every
// frame of a contiguous (T, N) uint8 stack on the card, where the decode left
// it, and writes the T values zlib.crc32 gives (reflected polynomial
// 0xEDB88320, initial value and final xor 0xFFFFFFFF).
//
// It replaces no Pallas kernel: the JAX package checks a range's frames with
// zlib on the host after the fetch (metalhuffman_tpu/models/frame_stream.py,
// verify_frame_crcs), and so did this port. Hashed here, before the fetch,
// the check leaves the request's critical path: the host compares T integers.
//
// What bounds it: bytes. Each frame byte is read once (from L2, where the
// decode has just written the frames of a request); the output is 4 bytes a
// frame.
//
// The design. CRC-32 with no initial value and no final xor ("raw", from
// state 0) is linear over GF(2), and leading zero bytes leave a raw CRC of 0
// unchanged. So a frame is read as if padded at its front with zero bytes to
// a whole number of chunks of kChunkBytes (32 KiB), and
//
//   crc32(frame) = raw(frame) ^ affine(N),   affine(N) = crc32(N zero bytes)
//   raw(A || B)  = Z^|B| raw(A) ^ raw(B)
//
// where Z^L is the 32x32 GF(2) matrix that feeds L zero bytes through the
// register. A CUDA block hashes one chunk of one frame: each of its 256
// threads a contiguous run of kRunBytes (128) bytes, loaded with the widest
// access that every frame start of the stack allows (16, 8, 4, 2 or 1
// bytes; frames of a stack whose N is no multiple of 16 start misaligned)
// and hashed 16 bytes a step with slicing-by-16 tables (16 x 256 words)
// that each block builds in its shared memory. The runs of a chunk combine
// in a tree, lane pairs by warp shuffles and then the eight warps' values in
// one warp: at level l the left value is advanced past its right neighbour's
// 128 * 2^l bytes, M[l] = Z^(128 * 2^l). The chunk's raw CRC is then
// advanced past the chunks that follow it in its frame (their count in
// binary, M[8 + b] = Z^(32 KiB * 2^b)), the frame's first chunk adds the
// affine term, and the block xors its value into the frame's output word
// (atomicXor: the order of the blocks does not matter). The entry zeroes the
// output with one memset on the stream before the launch.
//
// The host (ops/crc_cuda.py) builds the matrices once per process with the
// GF(2) helpers of core/crc.py (zlib's crc32_combine) and the affine term once
// per frame length, and passes them by value as a __grid_constant__
// parameter: no copy to the card and no stream synchronisation.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunBytes = 128;                        // bytes a thread hashes
constexpr int kRunWords = kRunBytes / 4;
constexpr int64_t kChunkBytes = kThreads * kRunBytes;  // bytes a block hashes
constexpr int kTreeLevels = 8;                        // log2(kThreads)
constexpr int kMatrices = 28;  // Z^(128 * 2^k), k < 28: 2^20 chunks a frame
static_assert(kThreads == 1 << kTreeLevels, "the tree halves the threads");

struct CrcParams {
  uint32_t mat[kMatrices][32];  // column i: the image of bit i
  uint32_t affine;              // crc32 of the frame length's zero bytes
};

// M v over GF(2)
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t (&m)[32],
                                              uint32_t v) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s ^= m[i] & (0u - ((v >> i) & 1u));
  return s;
}

// Slicing-by-16: the raw CRC `crc` advanced over the 16 bytes w0..w3
// (little-endian words, first byte lowest)
__device__ __forceinline__ uint32_t slice16(const uint32_t (*tab)[256],
                                            uint32_t crc, uint32_t w0,
                                            uint32_t w1, uint32_t w2,
                                            uint32_t w3) {
  const uint32_t a = crc ^ w0;
  return tab[15][a & 0xff] ^ tab[14][(a >> 8) & 0xff] ^
         tab[13][(a >> 16) & 0xff] ^ tab[12][a >> 24] ^
         tab[11][w1 & 0xff] ^ tab[10][(w1 >> 8) & 0xff] ^
         tab[9][(w1 >> 16) & 0xff] ^ tab[8][w1 >> 24] ^
         tab[7][w2 & 0xff] ^ tab[6][(w2 >> 8) & 0xff] ^
         tab[5][(w2 >> 16) & 0xff] ^ tab[4][w2 >> 24] ^
         tab[3][w3 & 0xff] ^ tab[2][(w3 >> 8) & 0xff] ^
         tab[1][(w3 >> 16) & 0xff] ^ tab[0][w3 >> 24];
}

// The run's bytes into words, VEC bytes a load; bytes before the frame's
// start (the chunk padding, offset < 0) read as zero. Every load is either
// wholly before the start or wholly inside the frame: the padding is a
// multiple of VEC.
template <int VEC>
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ frame,
                                         int64_t s, uint32_t (&w)[kRunWords]) {
#pragma unroll
  for (int j = 0; j < kRunBytes / VEC; ++j) {
    const int64_t o = s + j * VEC;
    const bool in = o >= 0;
    const uint8_t* p = frame + (in ? o : 0);
    if constexpr (VEC == 16) {
      const uint4 t = in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
      w[4 * j] = t.x, w[4 * j + 1] = t.y, w[4 * j + 2] = t.z, w[4 * j + 3] = t.w;
    } else if constexpr (VEC == 8) {
      const uint2 t = in ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
      w[2 * j] = t.x, w[2 * j + 1] = t.y;
    } else if constexpr (VEC == 4) {
      w[j] = in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    } else {
      constexpr int kPer = 4 / VEC;  // loads a word
      const uint32_t v =
          !in ? 0u
              : VEC == 2 ? (uint32_t)*reinterpret_cast<const uint16_t*>(p)
                         : (uint32_t)*p;
      if (j % kPer == 0) w[j / kPer] = 0;
      w[j / kPer] |= v << (8 * VEC * (j % kPer));
    }
  }
}

// Block b: chunk b % n_chunks of frame b / n_chunks. x: the stack, frames of
// n bytes, each frame's start VEC-aligned; pad = n_chunks * kChunkBytes - n.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
frame_crc_kernel(const uint8_t* __restrict__ x, int64_t n, int64_t n_chunks,
                 int64_t pad, uint32_t* __restrict__ out,
                 const __grid_constant__ CrcParams prm) {
  __shared__ uint32_t tab[16][256];
  __shared__ uint32_t warp_crc[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // the slicing tables: tab[k][i] is the raw CRC of byte i and k zero bytes
  uint32_t e = (uint32_t)tid;
#pragma unroll
  for (int k = 0; k < 8; ++k) e = (e >> 1) ^ (0xEDB88320u & (0u - (e & 1u)));
  tab[0][tid] = e;
  __syncthreads();
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    e = (e >> 8) ^ tab[0][e & 0xff];
    tab[k][tid] = e;
  }

  const int64_t f = blockIdx.x / n_chunks;
  const int64_t c = blockIdx.x - f * n_chunks;
  uint32_t w[kRunWords];
  load_run<VEC>(x + f * n, c * kChunkBytes + (int64_t)tid * kRunBytes - pad, w);
  __syncthreads();  // the tables are whole

  uint32_t crc = 0;
#pragma unroll
  for (int g = 0; g < kRunWords; g += 4) {
    crc = slice16(tab, crc, w[g], w[g + 1], w[g + 2], w[g + 3]);
  }

  // the runs of a warp: the left of each pair passes over the right's bytes
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t right = __shfl_down_sync(0xffffffffu, crc, 1 << l);
    if ((lane & ((2 << l) - 1)) == 0) crc = gf2_apply(prm.mat[l], crc) ^ right;
  }
  if (lane == 0) warp_crc[warp] = crc;
  __syncthreads();
  if (warp != 0) return;
  crc = lane < kWarps ? warp_crc[lane] : 0u;
#pragma unroll
  for (int l = 5; l < kTreeLevels; ++l) {
    const uint32_t right = __shfl_down_sync(0xffffffffu, crc, 1 << (l - 5));
    if ((lane & ((2 << (l - 5)) - 1)) == 0) {
      crc = gf2_apply(prm.mat[l], crc) ^ right;
    }
  }
  if (lane != 0) return;
  // past the chunks after this one in the frame
  for (int64_t k = n_chunks - 1 - c, b = kTreeLevels; k; k >>= 1, ++b) {
    if (k & 1) crc = gf2_apply(prm.mat[b], crc);
  }
  if (c == 0) crc ^= prm.affine;
  atomicXor(out + f, crc);
}

template <int VEC>
int launch(const uint8_t* x, int64_t n, int64_t t, int64_t n_chunks,
           uint32_t* out, const CrcParams& prm, cudaStream_t st) {
  const int64_t pad = n_chunks * kChunkBytes - n;
  frame_crc_kernel<VEC><<<(unsigned)(t * n_chunks), kThreads, 0, st>>>(
      x, n, n_chunks, pad, out, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// The CRC-32 of each of the t frames of n bytes at x into out[t] (uint32),
// read vec bytes at a time (x and n multiples of vec). params: uint32
// mat[28][32] (mat[k] feeds 128 * 2^k zero bytes through the register,
// column i the image of bit i), then crc32 of n zero bytes, as CrcParams.
// Zeroes out and launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int mht_frame_crc(const void* x, int64_t n, int64_t t, int vec,
                             const uint32_t* params, void* out, void* stream) {
  CrcParams prm;
  std::memcpy(&prm, params, sizeof(prm));
  const int64_t n_chunks = (n + kChunkBytes - 1) / kChunkBytes;
  if (n < 1 || t < 1 || n_chunks > (int64_t)1 << (kMatrices - kTreeLevels) ||
      t * n_chunks > INT32_MAX ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2 && vec != 1) ||
      n % vec != 0 || reinterpret_cast<uintptr_t>(x) % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, 4 * (size_t)t, st);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* p = static_cast<const uint8_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (vec) {
    case 16: return launch<16>(p, n, t, n_chunks, o, prm, st);
    case 8: return launch<8>(p, n, t, n_chunks, o, prm, st);
    case 4: return launch<4>(p, n, t, n_chunks, o, prm, st);
    case 2: return launch<2>(p, n, t, n_chunks, o, prm, st);
    default: return launch<1>(p, n, t, n_chunks, o, prm, st);
  }
}
