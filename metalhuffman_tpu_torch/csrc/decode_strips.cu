// Image decode with both sides of the data moved by the bulk-copy engine, on
// Hopper: a probe of B1 (decode_images.cu) that stages each CUDA block's code
// words into shared memory and stores its output as whole pixel-row runs.
//
// Replaces the TPU prototype scratch/kernel_strips.py::decode_strips (body
// make_kernel, :28-108), B1 with the 1-D delta whose kernel lane-interleaves
// each block row so that it stores image strips and only a coarse chunk swap
// is left after it. It computes B1's bytes: a shared-table batch of 8x8 blocks
// with the 1-D delta (the prototype's only precoder, :85) into a
// (T, bh*8, bw*8) uint8 image.
//
// Design: a CUDA block of 256 threads decodes 256 consecutive blocks of the
// raster block order, one per thread, with B1's lookup-table step
// (decode_common.cuh::decode_window_lut; table staged as B1 stages it).
//
// - In. The CUDA block's blocks occupy one contiguous span of the code words,
//   from offsets[b0] to the next CUDA block's first offset (the stream's end
//   for the last one) plus the 2 words a refill reads past a position. One
//   thread copies it into shared memory with cp.async.bulk on the table's
//   mbarrier, from the 16-byte word boundary below offsets[b0], its size
//   rounded up to 16 bytes (the buffer's last words, past its last 16-byte
//   boundary, go by plain loads); probes/strips.py::cta_spans computes the
//   same spans. The refills read the span. A refill that leaves it reads
//   global memory with B1's clamp, a branch that a well-formed stream never
//   takes: the span buffer holds the longest span of any complete code (256
//   blocks x 64 codes of 16 bits, 32 KB), so only a malformed offset index
//   has a span longer than the buffer, and its excess goes through that
//   branch. So S1's bytes equal B1's on any stream.
// - Out. The decode writes the strip in shared memory: row dy of local block
//   k at slot k of strip row dy. Then 8 threads, one per pixel row, store
//   each run of the row (the blocks of one block row, contiguous in the
//   image: a run ends at a block row's end, so 1920x1080's bw of 240 gives
//   up to 3 per CUDA block) with cp.async.bulk.global.shared::cta, which
//   needs no tensor map (a 2-D TMA store would need one per geometry, and a
//   run that crosses block rows is no box of it). A bulk copy needs 16-byte
//   alignment at both ends and a multiple of 16 bytes: with an even bw a
//   block's strip slot and its image position agree in parity, so every run
//   is whole; with an odd bw they agree or differ by block row, so each run
//   of the CUDA block is shifted by one slot more than the one before, and
//   by one more in rows where the parities differ (up to 7 runs: 8 spare
//   slots a row), and an odd block at either end of a run takes a plain
//   8-byte store. A CUDA block with more runs (bw odd and under ~40) stores
//   all its rows with B1's plain 8-byte stores.
//
// - Prefetch. A second form runs a persistent grid (as many CUDA blocks as
//   are resident at once) whose CUDA blocks walk the runs of 256 blocks in a
//   grid-stride loop with two span buffers: the next run's span is copied
//   while the current one decodes, and a run's stores are still in flight
//   while the next span lands. Its buffers are half the one-shot form's
//   each (16,400 bytes, over the photo's largest span of 14.4 KB), so both
//   forms keep the same residency; a span longer than that reads its excess
//   through the global branch.
//
// What bounds it on the H100: B1's instructions per symbol, less the
// refill's global loads, at fewer resident CUDA blocks: the span buffer
// (32,800 bytes), the strip (16,896) and the table (4 KB of T1 and the
// secondary tables) take 4 CUDA blocks per SM for the photo's table where B1
// fits 8. The probe measures whether the asynchronous movement of both sides
// makes up for that residency (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using mht::kThreads;

// the span buffer: 8192 words of the longest complete-code span, the
// 16-byte alignment below offsets[b0] (3 words), the 2 words a refill reads
// past a position and the rounding to 16 bytes
constexpr uint32_t kSpanWords = 8200;
// the prefetching form's two span buffers: 16,400 bytes each, so that it
// keeps the one-shot form's residency (the photo's spans are at most
// 14.4 KB; a longer span reads its excess through B1's refill)
constexpr uint32_t kPrefetchSpanWords = 4100;
// a strip row: the 256 blocks and up to 8 slots of shift
constexpr uint32_t kSlots = kThreads + 8;
constexpr uint32_t kMaxRuns = 7;  // runs of a CUDA block with an odd bw
constexpr uint32_t kStripBytes = 8 * kSlots * 8;
// beside the table: the span buffer(s) and the strip
constexpr uint32_t kExtraBytes = 4 * kSpanWords + kStripBytes;
static_assert(2 * kPrefetchSpanWords == kSpanWords,
              "both forms take the same shared memory");

// The code words a CUDA block holds in shared memory: [lo, hi), lo a
// multiple of 4 (16 bytes), hi a multiple of 4 unless it is the buffer's
// end (probes/strips.py::cta_spans), for the blocks b0 .. b0 + 255 and a
// buffer of `cap` words.
struct Span {
  uint32_t lo, hi;
};

__device__ __forceinline__ Span cta_span(const uint32_t* __restrict__ offsets,
                                         uint32_t n_blocks, uint32_t n_words,
                                         uint32_t b0, uint32_t cap) {
  const uint32_t lo = (offsets[b0] >> 5) & ~3u;
  uint64_t need = n_words;  // the last CUDA block: the buffer's end
  if (b0 + kThreads < n_blocks) need = (offsets[b0 + kThreads] >> 5) + 3;
  need = (need + 3) & ~(uint64_t)3;
  uint64_t hi = need < (uint64_t)lo + cap ? need : lo + cap;
  if (hi > n_words) hi = n_words;
  if (hi < lo) hi = lo;  // a malformed index: no span
  return Span{lo, (uint32_t)hi};
}

// The part of a span the bulk copy moves, [lo, bulk_hi): the rest, past the
// buffer's last 16-byte boundary, goes by plain loads (load_tail).
__device__ __forceinline__ uint32_t bulk_end(Span span, uint32_t n_words) {
  const uint32_t hi = span.hi < (n_words & ~3u) ? span.hi : (n_words & ~3u);
  return hi < span.lo ? span.lo : hi;
}

// Copy `bytes` (a multiple of 16, 16-byte aligned at both ends) from global
// into shared memory with the bulk-copy engine, completing on the mbarrier
// at shared address `bar`, as mht::stage_lut does.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  for (uint32_t off = 0; off < bytes; off += mht::kBulkChunk) {
    const uint32_t n =
        bytes - off < mht::kBulkChunk ? bytes - off : mht::kBulkChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(mht::smem_addr(static_cast<char*>(dst) + off)),
          "l"(static_cast<const char*>(src) + off), "r"(n), "r"(bar)
        : "memory");
  }
}

// By one thread: expect `extra` bytes besides the span's on the mbarrier
// `bar`, then copy the span's bulk part into s_words.
__device__ __forceinline__ void load_span(const uint32_t* __restrict__ words,
                                          uint32_t n_words, Span span,
                                          uint32_t* s_words, uint32_t extra,
                                          uint32_t bar) {
  const uint32_t bytes = 4 * (bulk_end(span, n_words) - span.lo);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(extra + bytes) : "memory");
  bulk_load(s_words, words + span.lo, bytes, bar);
}

// By threads 32..34: the span's words past the buffer's last 16-byte
// boundary, with plain loads (a __syncthreads() makes them visible).
__device__ __forceinline__ void load_tail(const uint32_t* __restrict__ words,
                                          uint32_t n_words, Span span,
                                          uint32_t* s_words) {
  const uint32_t w = bulk_end(span, n_words) + (threadIdx.x - 32);
  if (threadIdx.x >= 32 && w < span.hi) s_words[w - span.lo] = words[w];
}

__device__ __forceinline__ void init_barriers(uint32_t bar, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(bar + 8 * i) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised before anyone waits
}

// Every thread returns once the mbarrier `bar` has completed the phase of
// this parity (its bytes have landed).
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// mht::refill from the span when the 3 words at pos lie in it, else from
// global memory with B1's clamp. n3: the span's words less 2 (0 when it
// holds fewer than 3), so word index j of the span is in when j < n3.
__device__ __forceinline__ uint64_t span_refill(
    const uint32_t* s_words, uint32_t lo, uint32_t n3,
    const uint32_t* __restrict__ words, uint64_t last_word, uint64_t pos) {
  const uint32_t j = (uint32_t)(pos >> 5) - lo;  // wraps when below lo
  if (j < n3) {
    const uint32_t s = (uint32_t)(pos & 31);
    const uint64_t w01 = ((uint64_t)s_words[j] << 32) | s_words[j + 1];
    return (w01 << s) | ((uint64_t)s_words[j + 2] >> (32 - s));
  }
  return mht::refill(words, last_word, pos);
}

__device__ __forceinline__ void bulk_store(uint8_t* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
      ::"l"(dst), "r"(mht::smem_addr(src)), "r"(bytes) : "memory");
}

// The runs of a CUDA block's blocks b0 .. b0 + n - 1 in an image bw blocks
// wide: block rows r0 .. r1; with bulk, stored by bulk copies, shifted in
// the strip when bw is odd (shift); else by plain stores.
struct Layout {
  uint32_t b0, n, r0, r1;
  bool bulk, shift;
};

__device__ __forceinline__ Layout layout_of(uint32_t b0, uint32_t n_blocks,
                                            uint32_t bw) {
  Layout l;
  l.b0 = b0;
  l.n = n_blocks - b0 < kThreads ? n_blocks - b0 : kThreads;
  l.r0 = b0 / bw;
  l.r1 = (b0 + l.n - 1) / bw;
  const bool odd = (bw & 1) != 0;
  l.bulk = !odd || l.r1 - l.r0 < kMaxRuns;
  l.shift = odd && l.bulk;
  return l;
}

// Decode the layout's blocks, one per thread, from the span in s_words into
// the strip.
template <bool T2_SMEM>
__device__ __forceinline__ void decode_tile(
    const uint32_t* __restrict__ words, uint64_t last_word,
    const uint32_t* __restrict__ offsets, uint32_t bw, const Layout& l,
    Span span, const uint32_t* s_words, const int16_t* s_tab,
    const int16_t* t2, uint64_t* strip) {
  const uint32_t k = threadIdx.x;
  if (k >= l.n) return;
  const uint32_t n3 = span.hi - span.lo > 2 ? span.hi - span.lo - 2 : 0;
  const uint32_t slot = k + (l.shift ? (l.b0 + k) / bw - l.r0 : 0);
  uint64_t pos = offsets[l.b0 + k];  // absolute bit position; may pass 2^32
  uint32_t prev = 0;                 // 1-D delta accumulator
#pragma unroll 1
  for (int dy = 0; dy < 8; ++dy) {
    uint32_t lo, hi;  // pixels 0..3 and 4..7 of block row dy
    pos += mht::decode_window_lut<T2_SMEM, true>(
        span_refill(s_words, span.lo, n3, words, last_word, pos), s_tab, t2,
        prev, lo);
    pos += mht::decode_window_lut<T2_SMEM, true>(
        span_refill(s_words, span.lo, n3, words, last_word, pos), s_tab, t2,
        prev, hi);
    strip[dy * kSlots + slot + (l.shift ? (dy + l.r0) & 1 : 0)] =
        ((uint64_t)hi << 32) | lo;
  }
}

// Store the strip into the image: with l.bulk, threads 0..7 (one pixel row
// each) issue a bulk copy per run and commit them as their bulk group;
// else every thread stores its block's rows as B1 does. The caller makes
// the strip's writes visible to the async proxy and waits for the bulk
// group's reads before it writes the strip again.
__device__ __forceinline__ void store_tile(uint8_t* __restrict__ out,
                                           uint32_t bw, const Layout& l,
                                           const uint64_t* strip) {
  const uint32_t k = threadIdx.x;
  const uint64_t row_bytes = (uint64_t)bw * 8;
  if (!l.bulk) {  // B1's stores, from the strip
    if (k < l.n) {
      const uint64_t b = l.b0 + k, r = b / bw;
      uint8_t* dst = out + r * 8 * row_bytes + (b - r * bw) * 8;
#pragma unroll
      for (int dy = 0; dy < 8; ++dy) {
        *reinterpret_cast<uint64_t*>(dst + dy * row_bytes) =
            strip[dy * kSlots + k];
      }
    }
    return;
  }
  if (k >= 8) return;
  const uint32_t dy = k;  // this thread's pixel row of every block row
  for (uint32_t r = l.r0; r <= l.r1; ++r) {
    const uint64_t first = (uint64_t)r * bw;  // block r's first block
    uint32_t kb = first > l.b0 ? (uint32_t)(first - l.b0) : 0;
    uint32_t ke = first + bw < (uint64_t)l.b0 + l.n
                      ? (uint32_t)(first + bw - l.b0) : l.n;
    const uint32_t sh = l.shift ? (r - l.r0) + ((dy + l.r0) & 1) : 0;
    const uint64_t* src = strip + dy * kSlots + sh;  // [local block]
    uint8_t* row = out + ((uint64_t)r * 8 + dy) * row_bytes;
    auto dst = [&](uint32_t kk) {  // local block kk's bytes in the image
      return row + ((uint64_t)l.b0 + kk - first) * 8;
    };
    if ((reinterpret_cast<uintptr_t>(dst(kb)) & 15) != 0) {
      *reinterpret_cast<uint64_t*>(dst(kb)) = src[kb];
      ++kb;
    }
    if ((ke - kb) & 1) {
      --ke;
      *reinterpret_cast<uint64_t*>(dst(ke)) = src[ke];
    }
    if (ke > kb) bulk_store(dst(kb), src + kb, 8 * (ke - kb));
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// By threads 0..7: wait until this thread's bulk stores have read the strip.
__device__ __forceinline__ void strip_read() {
  if (threadIdx.x < 8) {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// The strip's generic-proxy writes, visible to the bulk copies' reads.
__device__ __forceinline__ void strip_written() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// One CUDA block per 256 blocks: the table and the span staged on one
// mbarrier, the decode, the stores.
template <bool T2_SMEM>
__global__ void __launch_bounds__(kThreads)
decode_strips_kernel(const uint32_t* __restrict__ words, uint32_t n_words,
                     const uint32_t* __restrict__ offsets, uint32_t n_blocks,
                     uint32_t bw, const int16_t* __restrict__ table,
                     uint32_t stage_bytes, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  int16_t* s_tab = reinterpret_cast<int16_t*>(smem);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + stage_bytes);
  uint64_t* strip =
      reinterpret_cast<uint64_t*>(smem + stage_bytes + 4 * kSpanWords);
  const uint32_t b = mht::smem_addr(&bar);
  const Layout l = layout_of(blockIdx.x * kThreads, n_blocks, bw);
  const Span span = cta_span(offsets, n_blocks, n_words, l.b0, kSpanWords);
  init_barriers(b, 1);
  if (threadIdx.x == 0) {
    load_span(words, n_words, span, s_words, stage_bytes, b);
    bulk_load(s_tab, table, stage_bytes, b);
  }
  load_tail(words, n_words, span, s_words);
  wait_phase(b, 0);
  __syncthreads();  // the tail's words are in place
  const int16_t* t2 = (T2_SMEM ? s_tab : table) + (1 << mht::kK1);
  decode_tile<T2_SMEM>(words, n_words - 3, offsets, bw, l, span, s_words,
                       s_tab, t2, strip);
  strip_written();
  store_tile(out, bw, l, strip);
  strip_read();  // the strip stays until the copies have read it
}

// The prefetching form: a persistent grid whose CUDA blocks walk the runs of
// 256 blocks (tiles) in a grid-stride loop, the span of the next tile copied
// into the second span buffer while the current one decodes, the stores of
// a tile still in flight while the next one's span lands.
template <bool T2_SMEM>
__global__ void __launch_bounds__(kThreads)
decode_strips_prefetch(const uint32_t* __restrict__ words, uint32_t n_words,
                       const uint32_t* __restrict__ offsets,
                       uint32_t n_blocks, uint32_t bw,
                       const int16_t* __restrict__ table,
                       uint32_t stage_bytes, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[2];
  int16_t* s_tab = reinterpret_cast<int16_t*>(smem);
  // span buffer i at s_span + i * kPrefetchSpanWords
  uint32_t* s_span = reinterpret_cast<uint32_t*>(smem + stage_bytes);
  uint64_t* strip =
      reinterpret_cast<uint64_t*>(smem + stage_bytes + 4 * kSpanWords);
  const uint32_t b = mht::smem_addr(bars);  // bars[i] at b + 8 * i
  const uint32_t n_tiles = (n_blocks + kThreads - 1) / kThreads;
  const int16_t* t2 = (T2_SMEM ? s_tab : table) + (1 << mht::kK1);
  init_barriers(b, 2);
  if (threadIdx.x == 0) {  // tile 0's span, and the table, on bars[0]
    const Span first = cta_span(offsets, n_blocks, n_words,
                                blockIdx.x * kThreads, kPrefetchSpanWords);
    load_span(words, n_words, first, s_span, stage_bytes, b);
    bulk_load(s_tab, table, stage_bytes, b);
  }
  uint32_t j = 0;  // this CUDA block's tile count
#pragma unroll 1
  for (uint32_t c = blockIdx.x; c < n_tiles; c += gridDim.x, ++j) {
    const uint32_t buf = j & 1;
    const uint32_t next = c + gridDim.x;
    // the other buffer was last read by the previous tile's decode, which
    // every thread finished before its stores
    if (threadIdx.x == 0 && next < n_tiles) {
      const Span s = cta_span(offsets, n_blocks, n_words, next * kThreads,
                              kPrefetchSpanWords);
      load_span(words, n_words, s, s_span + (buf ^ 1) * kPrefetchSpanWords,
                0, b + 8 * (buf ^ 1));
    }
    const Layout l = layout_of(c * kThreads, n_blocks, bw);
    const Span span =
        cta_span(offsets, n_blocks, n_words, l.b0, kPrefetchSpanWords);
    uint32_t* s_words = s_span + buf * kPrefetchSpanWords;
    load_tail(words, n_words, span, s_words);
    wait_phase(b + 8 * buf, (j >> 1) & 1);
    strip_read();     // the previous tile's stores have read the strip
    __syncthreads();  // and the tail's words are in place
    decode_tile<T2_SMEM>(words, n_words - 3, offsets, bw, l, span, s_words,
                         s_tab, t2, strip);
    strip_written();
    store_tile(out, bw, l, strip);
  }
  strip_read();
}

struct Args {
  const uint32_t* words;
  uint32_t n_words;
  const uint32_t* offsets;
  uint32_t n_blocks, bw;
  const int16_t* table;
  uint32_t stage_bytes;
  uint8_t* out;
  cudaStream_t stream;
};

// Launch (or with shape_only, only describe) one instance: one CUDA block
// per 256 blocks, or for PREFETCH as many as are resident at once (at most
// one per 256 blocks).
template <bool PREFETCH, bool T2_SMEM>
int run(const Args& a, bool shape_only, mht::GridShape* shape) {
  static mht::KernelCache cache;
  auto* kernel = PREFETCH ? decode_strips_prefetch<T2_SMEM>
                          : decode_strips_kernel<T2_SMEM>;
  const uint32_t smem = a.stage_bytes + kExtraBytes;
  int sms = 0;
  int err = mht::launch_facts(kernel, cache, smem, &sms, &shape->ctas_per_sm,
                              mht::kT2SmemMaxBytes + kExtraBytes);
  if (err) return err;
  const int tiles = (int)((a.n_blocks + kThreads - 1) / kThreads);
  const int resident = sms * shape->ctas_per_sm;
  shape->grid = PREFETCH && resident < tiles ? resident : tiles;
  shape->dyn_smem = (int)smem;
  if (shape_only) return mht::kernel_attributes(kernel, shape);
  kernel<<<shape->grid, kThreads, smem, a.stream>>>(
      a.words, a.n_words, a.offsets, a.n_blocks, a.bw, a.table, a.stage_bytes,
      a.out);
  return (int)cudaGetLastError();
}

int decode(const void* words, int64_t n_words, const void* offsets,
           int64_t n_blocks, int64_t bw, const void* table,
           int64_t table_entries, int t2_smem, int prefetch, void* out,
           void* stream, bool shape_only, mht::GridShape* shape) {
  const uint32_t stage_bytes = mht::lut_stage_bytes(table_entries, t2_smem);
  // the bulk copies need 16-byte aligned words and image
  if (n_words < 3 || n_words > INT32_MAX || n_blocks <= 0 ||
      n_blocks > INT32_MAX || bw <= 0 || bw > INT32_MAX || stage_bytes == 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const uint32_t*>(words), (uint32_t)n_words,
               static_cast<const uint32_t*>(offsets), (uint32_t)n_blocks,
               (uint32_t)bw, static_cast<const int16_t*>(table), stage_bytes,
               static_cast<uint8_t*>(out), static_cast<cudaStream_t>(stream)};
  if (prefetch) {
    return t2_smem ? run<true, true>(a, shape_only, shape)
                   : run<true, false>(a, shape_only, shape);
  }
  return t2_smem ? run<false, true>(a, shape_only, shape)
                 : run<false, false>(a, shape_only, shape);
}

}  // namespace

// Decode n_blocks = T*bh*bw 8x8 blocks with the 1-D delta into out, a
// 16-byte aligned (T, bh*8, bw*8) uint8 buffer. words: n_words big-endian
// u32 code words, 16-byte aligned; offsets: n_blocks u32 bit offsets;
// table, table_entries, t2_smem: the lookup table as mht_decode_images takes
// it; prefetch: 1 for the prefetching persistent form. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int mht_decode_strips(const void* words, int64_t n_words,
                                 const void* offsets, int64_t n_blocks,
                                 int64_t bw, const void* table,
                                 int64_t table_entries, int t2_smem,
                                 int prefetch, void* out, void* stream) {
  mht::GridShape shape;
  return decode(words, n_words, offsets, n_blocks, bw, table, table_entries,
                t2_smem, prefetch, out, stream, false, &shape);
}

// The grid mht_decode_strips launches for these arguments, and the kernel's
// occupancy, registers and local bytes, into shape[6] (mht::GridShape's
// fields in order). Launches nothing; returns a CUDA error (0 on success).
extern "C" int mht_decode_strips_shape(int64_t n_blocks, int64_t table_entries,
                                       int t2_smem, int prefetch, int* shape) {
  mht::GridShape s;
  const int err = decode(nullptr, 3, nullptr, n_blocks, 1, nullptr,
                         table_entries, t2_smem, prefetch, nullptr, nullptr,
                         true, &s);
  if (err) return err;
  const int v[6] = {s.ctas_per_sm, s.grid, s.dyn_smem, s.static_smem,
                    s.registers, s.local_bytes};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  return 0;
}
