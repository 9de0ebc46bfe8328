// The MHVT temporal fold on Hopper: every keyframe group of a (T, H, W[, C])
// stack of residual frames becomes its true frames, in place, in one launch.
//
// Replaces the ATen fold of models/temporal.py (temporal_fold and
// temporal_fold_mc with roll_groups: per frame slot of the groups a gather
// by row and column indices and an add, twelve ATen launches a slot). It
// replaces no Pallas kernel: the JAX package folds with lax.scan
// (metalhuffman_tpu/models/temporal.py, temporal_decode_jax and
// temporal_decode_mc_jax).
//
// The function. Within a group opening at keyframe k, frame s > k is
//
//   out[s](y, x) = res[s](y, x) + out[s-1]((y - dy[s]) mod H, (x - dx[s]) mod W)
//
// wrapping in the element type (uint8 or uint16); the group fold is the same
// with every vector (0, 0). The keyframe is its own residual.
//
// What bounds it: bytes. Every residual is read once and every non-key frame
// written once, in place; there are no operations of note. The least time is
// the stack's bytes twice over the HBM rate.
//
// How it keeps to that traffic. A CUDA block owns `rows` keyframe rows of one
// group, whole rows, and walks the group's slots in order. Row r of the block
// is a chain: at slot s it sits at image row (r0 + r + cy[s]) mod H, where
// cy[s] is the group's cumulative row shift, since a row shift moves whole
// rows. The block keeps the chain rows' previous frame in shared memory
// (twice, one buffer read while the other is written), so out[s-1] is never
// read back from device memory: per slot each thread loads its chunks of
// res[s] with 16-byte loads of neighbouring addresses, adds the previous
// frame's bytes shifted by the slot's own column shift sx[s] (x - dx), read
// from shared memory, and stores the sum to the same place in device memory
// and in the other buffer. Because a block owns whole rows, every chunk it
// stores is its own: no chunk is shared with another block, whatever the
// shift. The column shift's misalignment is taken from two aligned chunks of
// shared memory with funnel shifts (the shift is the same for every thread
// of a slot, so the selection never diverges), and the row's wrap seam by
// wrapping the second chunk's offset to 0. So each residual is read once,
// each frame written once, and the keyframe read once and left as it is.
//
// Rows too wide for two buffers of one row in shared memory (over 116,224
// bytes) take the same walk reading out[s-1] back from device memory, where
// the block stored it in the slot before (with ld.global.cg, from L2, which
// still holds it); that path reads the previous frame's bytes once more and
// is there so that every width folds.
//
// The host (ops/fold_cuda.py) computes the group table, the cumulative row
// shifts and the column shifts (a few dozen ints) and passes them by value as
// a __grid_constant__ parameter: the fold makes no host-to-device copy and no
// stream synchronisation. A stack whose groups need more frames than one
// table holds splits into launches of whole groups (a group longer than the
// table into pieces that overlap by one frame: a piece's keyframe is the last
// frame its predecessor folded).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunksPerThread = 4;  // chunks a thread loads before it adds
constexpr int kTableFrames = 256;    // frames one table describes
constexpr int kTableGroups = 128;    // groups one table describes
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may take
static_assert(2 * kTableGroups >= kTableFrames,
              "a group has at least two frames");

// The launch's groups and shifts; frames are counted from the launch's base
struct FoldTable {
  int32_t n_groups;
  int32_t start[kTableGroups];  // the keyframe of each group
  int32_t len[kTableGroups];    // its frames, keyframe included (>= 2)
  int32_t cy[kTableFrames];     // cumulative row shift from the keyframe, [0, H)
  int32_t sx[kTableFrames];     // the frame's own column shift in bytes, [0, row)
};

// VEC bytes of a row in 32-bit words; VEC < 4 uses the low bytes of one word
template <int VEC>
struct Chunk {
  uint32_t w[VEC >= 4 ? VEC / 4 : 1];
};

template <int VEC>
__device__ __forceinline__ Chunk<VEC> load(const uint8_t* p) {
  Chunk<VEC> v;
  if constexpr (VEC == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    v.w[0] = t.x, v.w[1] = t.y, v.w[2] = t.z, v.w[3] = t.w;
  } else if constexpr (VEC == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v.w[0] = t.x, v.w[1] = t.y;
  } else if constexpr (VEC == 4) {
    v.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (VEC == 2) {
    v.w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    v.w[0] = *p;
  }
  return v;
}

// load<VEC> through L2 alone (ld.global.cg): bytes that other threads of
// the block stored before a __syncthreads
template <int VEC>
__device__ __forceinline__ Chunk<VEC> load_cg(const uint8_t* p) {
  Chunk<VEC> v;
  if constexpr (VEC == 16) {
    const uint4 t = __ldcg(reinterpret_cast<const uint4*>(p));
    v.w[0] = t.x, v.w[1] = t.y, v.w[2] = t.z, v.w[3] = t.w;
  } else if constexpr (VEC == 8) {
    const uint2 t = __ldcg(reinterpret_cast<const uint2*>(p));
    v.w[0] = t.x, v.w[1] = t.y;
  } else if constexpr (VEC == 4) {
    v.w[0] = __ldcg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    v.w[0] = __ldcg(reinterpret_cast<const unsigned short*>(p));
  } else {
    v.w[0] = __ldcg(p);
  }
  return v;
}

template <int VEC>
__device__ __forceinline__ void store(uint8_t* p, const Chunk<VEC>& v) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(p) = v.w[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)v.w[0];
  } else {
    *p = (uint8_t)v.w[0];
  }
}

// The VEC bytes that start `a` bytes into the chunk `lo`, `hi` following it
template <int VEC>
__device__ __forceinline__ Chunk<VEC> window(const Chunk<VEC>& lo,
                                             const Chunk<VEC>& hi, int a) {
  Chunk<VEC> out;
  if constexpr (VEC >= 4) {
    constexpr int kW = VEC / 4;
    uint32_t y[2 * kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) y[k] = lo.w[k], y[kW + k] = hi.w[k];
    // drop a / 4 whole words in two selects of a uniform predicate, so the
    // words stay in registers
    if constexpr (kW >= 4) {
      if (a & 8) {
#pragma unroll
        for (int k = 0; k < 2 * kW - 2; ++k) y[k] = y[k + 2];
      }
    }
    if constexpr (kW >= 2) {
      if (a & 4) {
#pragma unroll
        for (int k = 0; k < 2 * kW - 1; ++k) y[k] = y[k + 1];
      }
    }
    const unsigned r = 8u * (unsigned)(a & 3);
#pragma unroll
    for (int k = 0; k < kW; ++k) out.w[k] = __funnelshift_r(y[k], y[k + 1], r);
  } else {
    out.w[0] = (lo.w[0] | (hi.w[0] << (8 * VEC))) >> (8 * a);
  }
  return out;
}

// Element-wise wrapping add of ES-byte elements
template <int ES, int VEC>
__device__ __forceinline__ Chunk<VEC> add(Chunk<VEC> a, const Chunk<VEC>& b) {
#pragma unroll
  for (int k = 0; k < (VEC >= 4 ? VEC / 4 : 1); ++k) {
    a.w[k] = ES == 1 ? __vadd4(a.w[k], b.w[k]) : __vadd2(a.w[k], b.w[k]);
  }
  return a;
}

__host__ __device__ constexpr int pitch(int row_bytes) {
  return (row_bytes + 15) / 16 * 16;
}

// Block (blockIdx.x, blockIdx.y): keyframe rows [blockIdx.x * rows, + rows)
// of group blockIdx.y. x: the launch's first frame; frames of h rows of
// row_bytes bytes, row_bytes a multiple of VEC and x VEC-aligned. SHARED:
// the previous frame in shared memory, else read back from device memory.
template <int ES, int VEC, bool SHARED>
__global__ void __launch_bounds__(kThreads)
temporal_fold_kernel(uint8_t* __restrict__ x, int h, int row_bytes, int rows,
                     const __grid_constant__ FoldTable tab) {
  extern __shared__ uint4 smem[];
  uint8_t* const buf = reinterpret_cast<uint8_t*>(smem);
  const int p = pitch(row_bytes);
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int n_rows = min(rows, h - r0);
  const int per_row = row_bytes / VEC;
  const int m = n_rows * per_row;  // chunks of the block, per frame
  const int k = tab.start[g];
  const int n = tab.len[g];
  const int64_t frame_bytes = (int64_t)h * row_bytes;
  constexpr int kBatch = kThreads * kChunksPerThread;

  // the keyframe's rows into buffer 0
  const uint8_t* key = x + k * frame_bytes;
  for (int base = 0; SHARED && base < m; base += kBatch) {
    Chunk<VEC> v[kChunksPerThread];
#pragma unroll
    for (int j = 0; j < kChunksPerThread; ++j) {
      const int i = base + j * kThreads + (int)threadIdx.x;
      if (i < m) {
        const int r = i / per_row, c = (i - r * per_row) * VEC;
        v[j] = load<VEC>(key + (int64_t)(r0 + r) * row_bytes + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunksPerThread; ++j) {
      const int i = base + j * kThreads + (int)threadIdx.x;
      if (i < m) {
        const int r = i / per_row, c = (i - r * per_row) * VEC;
        store<VEC>(buf + r * p + c, v[j]);
      }
    }
  }
  __syncthreads();

  for (int s = 1; s < n; ++s) {
    const int f = k + s;
    const int cy = tab.cy[f];
    const int sh = tab.sx[f];
    const int a = (row_bytes - sh) % VEC;  // the window's misalignment
    const int cy_prev = tab.cy[f - 1];  // 0 at the keyframe
    const uint8_t* prev_frame = x + (f - 1) * frame_bytes;
    const uint8_t* prev = buf + ((s - 1) & 1) * rows * p;
    uint8_t* next = buf + (s & 1) * rows * p;
    uint8_t* frame = x + f * frame_bytes;
    const bool last = s == n - 1;
    for (int base = 0; base < m; base += kBatch) {
      Chunk<VEC> v[kChunksPerThread];
      int64_t at[kChunksPerThread];
#pragma unroll
      for (int j = 0; j < kChunksPerThread; ++j) {
        const int i = base + j * kThreads + (int)threadIdx.x;
        if (i < m) {
          const int r = i / per_row, c = (i - r * per_row) * VEC;
          int y = r0 + r + cy;
          if (y >= h) y -= h;
          at[j] = (int64_t)y * row_bytes + c;
          v[j] = load<VEC>(frame + at[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunksPerThread; ++j) {
        const int i = base + j * kThreads + (int)threadIdx.x;
        if (i < m) {
          const int r = i / per_row, c = (i - r * per_row) * VEC;
          int o = c - sh;  // the previous frame's byte under column c
          if (o < 0) o += row_bytes;
          const int c0 = o - a;
          int c1 = c0 + VEC;
          if (c1 == row_bytes) c1 = 0;
          Chunk<VEC> lo, hi;
          if constexpr (SHARED) {
            const uint8_t* pr = prev + r * p;
            lo = load<VEC>(pr + c0), hi = load<VEC>(pr + c1);
          } else {
            int y = r0 + r + cy_prev;
            if (y >= h) y -= h;
            const uint8_t* pr = prev_frame + (int64_t)y * row_bytes;
            lo = load_cg<VEC>(pr + c0), hi = load_cg<VEC>(pr + c1);
          }
          const Chunk<VEC> out = add<ES, VEC>(v[j], window<VEC>(lo, hi, a));
          store<VEC>(frame + at[j], out);
          if (SHARED && !last) store<VEC>(next + r * p + c, out);
        }
      }
    }
    if (!last) __syncthreads();
  }
}

template <int ES, int VEC, bool SHARED>
int launch_path(uint8_t* x, int h, int row_bytes, int rows,
                const FoldTable& tab, cudaStream_t st) {
  const size_t smem = SHARED ? 2 * (size_t)rows * pitch(row_bytes) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        temporal_fold_kernel<ES, VEC, SHARED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((h + rows - 1) / rows), (unsigned)tab.n_groups);
  temporal_fold_kernel<ES, VEC, SHARED>
      <<<grid, kThreads, smem, st>>>(x, h, row_bytes, rows, tab);
  return (int)cudaGetLastError();
}

template <int ES, int VEC>
int launch(uint8_t* x, int h, int row_bytes, int rows, bool shared,
           const FoldTable& tab, cudaStream_t st) {
  return shared ? launch_path<ES, VEC, true>(x, h, row_bytes, rows, tab, st)
                : launch_path<ES, VEC, false>(x, h, row_bytes, rows, tab, st);
}

}  // namespace

// Fold the groups of `table` (int32: n_groups, start[128], len[128], cy[256],
// sx[256], as FoldTable) in the stack at x: frames of h rows of row_bytes
// bytes, elements of elem_bytes (1 or 2) bytes, accessed vec bytes at a time
// (row_bytes and x multiples of vec), `rows` keyframe rows a CUDA block,
// their previous frame in shared memory if `shared` (two buffers of `rows`
// rows within kSmemMax), else read back from device memory. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mht_temporal_fold(void* x, int64_t h, int64_t row_bytes,
                                 int elem_bytes, int vec, int rows,
                                 int shared, const int32_t* table,
                                 void* stream) {
  FoldTable tab;
  std::memcpy(&tab, table, sizeof(tab));
  if (h < 1 || h > INT32_MAX || row_bytes < 1 || row_bytes > INT32_MAX ||
      rows < 1 || tab.n_groups < 1 || tab.n_groups > kTableGroups ||
      (elem_bytes != 1 && elem_bytes != 2) || vec < elem_bytes ||
      row_bytes % vec != 0 || reinterpret_cast<uintptr_t>(x) % vec != 0 ||
      (shared && 2 * (int64_t)rows * pitch((int)row_bytes) > kSmemMax)) {
    return (int)cudaErrorInvalidValue;
  }
  uint8_t* p = static_cast<uint8_t*>(x);
  const int hh = (int)h, rb = (int)row_bytes;
  const bool sh = shared != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    switch (vec) {
      case 16: return launch<1, 16>(p, hh, rb, rows, sh, tab, st);
      case 8: return launch<1, 8>(p, hh, rb, rows, sh, tab, st);
      case 4: return launch<1, 4>(p, hh, rb, rows, sh, tab, st);
      case 2: return launch<1, 2>(p, hh, rb, rows, sh, tab, st);
      case 1: return launch<1, 1>(p, hh, rb, rows, sh, tab, st);
    }
  } else {
    switch (vec) {
      case 16: return launch<2, 16>(p, hh, rb, rows, sh, tab, st);
      case 8: return launch<2, 8>(p, hh, rb, rows, sh, tab, st);
      case 4: return launch<2, 4>(p, hh, rb, rows, sh, tab, st);
      case 2: return launch<2, 2>(p, hh, rb, rows, sh, tab, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
