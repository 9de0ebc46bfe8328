// Integer rate probe on Hopper: is 16-bit arithmetic faster per element than
// 32-bit? It decides whether packing two symbols' state into one register
// (SWAR) can pay in the decode chain.
//
// Replaces the TPU probe scratch/int16_rate.py::run (body make_kernel, :24-33),
// which timed CHAIN = 512 dependent pairs `v += 1; acc += (v > 7)`, then
// `out = v + acc`, on int32 (8,128) tiles against int16 (16,128) and (8,128)
// tiles. Three variants here, each one chain per thread over the same
// elements:
//
//   i32    int32, one element per thread register;
//   i16    int16, one element per thread (the same element count);
//   i16x2  two int16 elements packed in one 32-bit register, through the
//          SIMD intrinsics __vadd2, __vcmpgts2 and __vsub2: twice the
//          elements per register, as the TPU's (16,128) tile.
//
// The step (1) and the threshold (7) are kernel arguments, so the compiler
// cannot fold the chain into a closed form; the output is that of the chain
// with int16/int32 wraparound.
//
// What bounds it: integer operations, 3 per element per chain step for i32 and
// i16, 3 per register (two elements) for i16x2; the inputs and outputs are a
// few bytes per element. What each intrinsic lowers to in SASS decides the
// i16x2 rate: on sm_90a __vadd2 is one VIADD.16x2, but __vcmpgts2 takes five
// instructions, so i16x2 issues about as many per element as i32 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChain = 512;  // dependent op pairs per element
constexpr int kThreads = 256;
// the variant ids of probes/int16_rate.py::VARIANTS
constexpr int kI32 = 0, kI16 = 1, kI16x2 = 2;

__global__ void __launch_bounds__(kThreads)
rate_i32(const int32_t* __restrict__ x, int64_t n, int32_t step,
         int32_t thresh, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // unsigned adds: the wraparound of the plain version, defined in C++
  uint32_t v = (uint32_t)x[i], acc = 0;
#pragma unroll 16
  for (int k = 0; k < kChain; ++k) {
    v += (uint32_t)step;
    acc += (int32_t)v > thresh;
  }
  out[i] = (int32_t)(v + acc);
}

__global__ void __launch_bounds__(kThreads)
rate_i16(const int16_t* __restrict__ x, int64_t n, int16_t step,
         int16_t thresh, int16_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int16_t v = x[i], acc = 0;
#pragma unroll 16
  for (int k = 0; k < kChain; ++k) {
    v = (int16_t)(v + step);
    acc = (int16_t)(acc + (v > thresh));
  }
  out[i] = (int16_t)(v + acc);
}

// x, out: n2 registers of two int16 elements each (element 2j in the low half)
__global__ void __launch_bounds__(kThreads)
rate_i16x2(const uint32_t* __restrict__ x, int64_t n2, uint32_t step2,
           uint32_t thresh2, uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  uint32_t v = x[i], acc = 0;
#pragma unroll 16
  for (int k = 0; k < kChain; ++k) {
    v = __vadd2(v, step2);
    acc = __vsub2(acc, __vcmpgts2(v, thresh2));  // a true lane is 0xffff: -1
  }
  out[i] = __vadd2(v, acc);
}

}  // namespace

// Run the chain over n elements of x into out, as variant `variant` (0 i32:
// int32 elements; 1 i16, 2 i16x2: int16 elements, n even for i16x2), with
// `step` and `thresh` (1 and 7 for the TPU probe's chain). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mht_int16_rate(const void* x, int64_t n, int variant,
                              int32_t step, int32_t thresh, void* out,
                              void* stream) {
  if (n <= 0 || variant < kI32 || variant > kI16x2 ||
      (variant == kI16x2 && n % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t threads = variant == kI16x2 ? n / 2 : n;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  if (variant == kI32) {
    rate_i32<<<grid, kThreads, 0, st>>>(static_cast<const int32_t*>(x), n,
                                        step, thresh,
                                        static_cast<int32_t*>(out));
  } else if (variant == kI16) {
    rate_i16<<<grid, kThreads, 0, st>>>(static_cast<const int16_t*>(x), n,
                                        (int16_t)step, (int16_t)thresh,
                                        static_cast<int16_t*>(out));
  } else {
    const uint32_t step2 = (uint16_t)step * 0x10001u;
    const uint32_t thresh2 = (uint16_t)thresh * 0x10001u;
    rate_i16x2<<<grid, kThreads, 0, st>>>(static_cast<const uint32_t*>(x),
                                          threads, step2, thresh2,
                                          static_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}
