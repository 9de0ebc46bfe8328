// Host encoder of metalhuffman_tpu_torch (C++17, no deps).
//
// The encode half of metalhuffman_tpu/native/src/mht_codec.cpp, copied: the
// canonical Huffman length assignment (heap Huffman + package-merge cap 16),
// canonical code generation, MSB-first bit packing with per-block offsets
// (serial and multithreaded), the row merge of the hybrid device encoder, and
// the per-block 1-D and 2-D delta precoders.
// The decoders and the fixed-table entry of the original are not copied: the
// port decodes on the device. Tests hold every output byte-equal to the
// original's.
//
// Behavioral parity targets in the reference (capability, not code):
//   - 256-byte bit-width wire header        (huff_util.hpp:45-68)
//   - (width, symbol)-sorted canonical codes, left-justified 16-bit
//                                            (huff_util.hpp:94-193)
//   - MSB-first packing + 2 read-ahead pad   (HuffmanEncoder.cpp:211-276,371-378)
//   - per-block bit offsets                  (HuffmanUtil.cpp:1102-1117)
//
// All entry points return 0 on success, negative error codes otherwise.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr int kNumSymbols = 256;
constexpr int kMaxCodeLen = 16;

struct HeapNode {
  int64_t weight;
  int32_t tiebreak;  // smallest symbol in subtree
  int32_t id;
  bool operator>(const HeapNode& o) const {
    if (weight != o.weight) return weight > o.weight;
    if (tiebreak != o.tiebreak) return tiebreak > o.tiebreak;
    return id > o.id;
  }
};

// Optimal Huffman code lengths via a min-heap; tie-breaking identical to the
// NumPy mirror (weight, then smallest symbol in subtree, then node id).
void huffman_lengths_unlimited(const int64_t* freqs, uint8_t* lengths) {
  std::memset(lengths, 0, kNumSymbols);
  std::vector<int> active;
  for (int s = 0; s < kNumSymbols; ++s)
    if (freqs[s] > 0) active.push_back(s);
  if (active.empty()) return;
  if (active.size() == 1) {
    lengths[active[0]] = 1;  // single symbol: one 1-bit code
    return;
  }
  std::priority_queue<HeapNode, std::vector<HeapNode>, std::greater<HeapNode>> heap;
  for (int s : active) heap.push({freqs[s], s, s});
  int next_id = kNumSymbols;
  std::vector<int> parent(kNumSymbols + active.size(), -1);
  while (heap.size() > 1) {
    HeapNode a = heap.top(); heap.pop();
    HeapNode b = heap.top(); heap.pop();
    parent[a.id] = next_id;
    parent[b.id] = next_id;
    heap.push({a.weight + b.weight, std::min(a.tiebreak, b.tiebreak), next_id});
    ++next_id;
  }
  std::vector<int> depth(next_id, 0);
  for (int nid = next_id - 2; nid >= 0; --nid)
    if (parent[nid] >= 0) depth[nid] = depth[parent[nid]] + 1;
  for (int s : active) lengths[s] = static_cast<uint8_t>(depth[s]);
}

// Length-limited lengths via package-merge; ordering/stability matches the
// NumPy mirror exactly (stable sort by (weight, tiebreak), leaves tagged with
// their symbol, packages tagged 256).
int package_merge_lengths(const int64_t* freqs, int max_len, uint8_t* lengths) {
  std::memset(lengths, 0, kNumSymbols);
  std::vector<int> active;
  for (int s = 0; s < kNumSymbols; ++s)
    if (freqs[s] > 0) active.push_back(s);
  const int n = static_cast<int>(active.size());
  if (n == 0) return 0;
  if (n == 1) { lengths[active[0]] = 1; return 0; }
  if (n > (1 << max_len)) return -2;

  struct Item {
    int64_t w;
    int32_t tag;  // symbol for leaves, 256 for packages
    std::vector<uint16_t> vec;  // leaf multiplicity per symbol
  };
  std::vector<Item> leaves;
  leaves.reserve(n);
  for (int s : active) {
    Item it{freqs[s], s, std::vector<uint16_t>(kNumSymbols, 0)};
    it.vec[s] = 1;
    leaves.push_back(std::move(it));
  }
  std::stable_sort(leaves.begin(), leaves.end(), [](const Item& a, const Item& b) {
    return a.w != b.w ? a.w < b.w : a.tag < b.tag;
  });

  std::vector<Item> prev_packages;
  auto build_items = [&](std::vector<Item>& items) {
    items.clear();
    for (const Item& l : leaves) items.push_back(l);
    for (const Item& p : prev_packages) items.push_back(p);
    std::stable_sort(items.begin(), items.end(), [](const Item& a, const Item& b) {
      return a.w != b.w ? a.w < b.w : a.tag < b.tag;
    });
  };

  std::vector<Item> items;
  for (int level = 0; level < max_len - 1; ++level) {
    build_items(items);
    prev_packages.clear();
    for (size_t i = 0; i + 1 < items.size(); i += 2) {
      Item pkg{items[i].w + items[i + 1].w, kNumSymbols,
               std::vector<uint16_t>(kNumSymbols, 0)};
      for (int s = 0; s < kNumSymbols; ++s)
        pkg.vec[s] = static_cast<uint16_t>(items[i].vec[s] + items[i + 1].vec[s]);
      prev_packages.push_back(std::move(pkg));
    }
  }
  build_items(items);
  std::vector<int32_t> counts(kNumSymbols, 0);
  const int take = 2 * (n - 1);
  for (int i = 0; i < take && i < static_cast<int>(items.size()); ++i)
    for (int s = 0; s < kNumSymbols; ++s) counts[s] += items[i].vec[s];
  for (int s : active) lengths[s] = static_cast<uint8_t>(counts[s]);
  return 0;
}

// Canonical codes, left-justified in 16 bits; (width, symbol) sort order.
void canonical_codes_impl(const uint8_t* widths, uint16_t* codes) {
  std::memset(codes, 0, kNumSymbols * sizeof(uint16_t));
  std::vector<std::pair<int, int>> order;  // (width, symbol)
  for (int s = 0; s < kNumSymbols; ++s)
    if (widths[s] > 0) order.emplace_back(widths[s], s);
  std::sort(order.begin(), order.end());
  uint32_t current = 0;
  for (size_t i = 0; i < order.size(); ++i) {
    const int w = order[i].first;
    const int s = order[i].second;
    codes[s] = static_cast<uint16_t>((current << (16 - w)) & 0xFFFF);
    ++current;
    if (i + 1 < order.size() && order[i + 1].first > w)
      current <<= (order[i + 1].first - w);
  }
}

}  // namespace

extern "C" {

// Huffman code lengths (<= 16 bits) from a 256-entry frequency table.
int mht_code_lengths(const int64_t* freqs, uint8_t* widths_out) {
  huffman_lengths_unlimited(freqs, widths_out);
  int max_w = 0;
  for (int s = 0; s < kNumSymbols; ++s) max_w = std::max(max_w, (int)widths_out[s]);
  if (max_w > kMaxCodeLen)
    return package_merge_lengths(freqs, kMaxCodeLen, widths_out);
  return 0;
}

// Left-justified 16-bit canonical codes from a 256-entry width table.
int mht_canonical_codes(const uint8_t* widths, uint16_t* codes_out) {
  canonical_codes_impl(widths, codes_out);
  return 0;
}

namespace {

// Fused (width << 24) | (code >> (16 - width)) entries; width 0 -> 0.
inline void build_pack_entries(const uint8_t* widths, const uint16_t* codes,
                               uint32_t* ent) {
  for (int s = 0; s < kNumSymbols; ++s) {
    const int w = widths[s];
    ent[s] = w == 0 ? 0u
                    : (static_cast<uint32_t>(w) << 24) |
                          (static_cast<uint32_t>(codes[s]) >> (16 - w));
  }
}

// -- pair-table rolling packer (round 3) --------------------------------------
//
// Two prototypes measured on the original's 2.1 GHz host (scratch/
// bench_pack.cpp): the per-symbol loop is bound by instruction throughput
// (~10 uops/symbol), not by latency —
// interleaving 4 independent accumulator chains moved nothing, while
// halving the op count with a 64K PAIR table (two symbols per lookup)
// measured 1.18 GB/s/core vs 0.44 for every single-symbol variant (~2.7x).
// Pack state is one branchless rolling 64-bit window: deposit the pair's
// <= 32 code bits at the window offset, PLAIN-store 8 bytes big-endian
// (overlapping stores never stall; there is no flush branch at all), and
// rebase the window to the new byte cursor. Chunk seams (the bytes shared
// with neighbor threads) use a byte-wise OR packer that skips zero bytes,
// so no two threads ever touch the same byte (head bytes additionally
// divert to a side slot, merged after the join).


inline void store_be64(uint8_t* q, uint64_t v) {
  v = __builtin_bswap64(v);
  std::memcpy(q, &v, 8);
}

// Entry for the byte pair (a, b) at index (b << 8 | a) — one little-endian
// u16 load of the data IS the index: joint width wa+wb (<= 32) in bits
// 40.., combined code (ca << wb | cb) in bits 0..31.
inline void build_pair_entries(const uint32_t* ent, uint64_t* tbl) {
  for (int b = 0; b < kNumSymbols; ++b) {
    const uint32_t eb = ent[b];
    const uint64_t wb = eb >> 24, cb = eb & 0xFFFFu;
    for (int a = 0; a < kNumSymbols; ++a) {
      const uint32_t ea = ent[a];
      tbl[(b << 8) | a] =
          (((ea >> 24) + wb) << 40) | (((uint64_t)(ea & 0xFFFFu)) << wb) | cb;
    }
  }
}

// Byte-wise single chain for chunk SEAMS: zero window bytes are skipped
// (never even touched), so the chain's writes stay strictly within the
// bytes its own bits occupy — no store window ever reaches into the next
// thread's region. With head_slot set, bytes landing on head_idx (the
// chunk's first byte, shared with the previous thread's tail) divert to
// the side slot (merged serially after the join — see mht_encode_mt).
// Used only for a chunk's first/last blocks and tail symbols.
inline void pack_block1_safe(const uint8_t* data, int64_t lo, int64_t hi,
                             const uint32_t* ent, int64_t& p, uint8_t* out,
                             int64_t head_idx = -1,
                             uint8_t* head_slot = nullptr) {
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t e = ent[data[i]];
    const int w = static_cast<int>(e >> 24);
    const uint32_t v = (e & 0xFFFFu)
                       << (32 - w - static_cast<int>(p & 7));
    for (int k = 0; k < 4; ++k) {
      const uint8_t b = static_cast<uint8_t>(v >> (24 - 8 * k));
      if (b == 0) continue;  // OR of 0 is a no-op: skip the write entirely
      const int64_t idx = (p >> 3) + k;
      if (idx == head_idx)
        *head_slot |= b;
      else
        out[idx] |= b;
    }
    p += w;
  }
}

// Pack data[lo, hi) starting at absolute bit chunk_bit: byte-wise seams,
// pair-table rolling-store fast path for the middle blocks, per-block
// offsets from the running bit cursor. Shared by the single-thread and
// per-thread encode paths.
void pack_chunk_or(const uint8_t* data, int64_t lo, int64_t hi,
                   int64_t block_size, int64_t n_blocks_total,
                   int64_t chunk_bit, const uint32_t* ent,
                   const uint64_t* pair_tbl, uint8_t* out,
                   uint32_t* block_offsets_out, uint8_t* head_slot) {
  int64_t p = chunk_bit;
  int64_t i = lo;
  int64_t b = lo / block_size;
  const int64_t hi_whole = std::min(hi, n_blocks_total * block_size);
  // head seam: while the bit cursor's byte is still the chunk's first
  // (shared) byte, pack whole blocks byte-wise with that byte diverted
  // (normally exactly one block)
  while ((chunk_bit & 7) && head_slot != nullptr && i < hi
         && (p >> 3) == (chunk_bit >> 3)) {
    const int64_t stop = std::min(hi, (b + 1) * block_size);
    if (i < hi_whole) block_offsets_out[b] = static_cast<uint32_t>(p);
    pack_block1_safe(data, i, stop, ent, p, out, chunk_bit >> 3, head_slot);
    i = stop;
    ++b;
  }
  // fast middle: whole blocks, PROVABLY keeping >= 64 same-chunk symbols
  // (hence >= 64 bits >= one full store window) after the span so the
  // 8-byte plain stores never reach bytes owned by the next thread
  if (i + block_size <= hi_whole && hi - (i + block_size) >= 64) {
    int64_t p0 = p >> 3;
    // continue the partial byte the head seam already wrote (0 if none)
    uint64_t acc = static_cast<uint64_t>(out[p0]) << 56;
    while (i + block_size <= hi_whole && hi - (i + block_size) >= 64) {
      block_offsets_out[b++] = static_cast<uint32_t>(p);
      int64_t j = i;
      const int64_t stop = i + block_size;
      for (; j + 1 < stop; j += 2) {
        uint16_t idx;
        std::memcpy(&idx, data + j, 2);
        const uint64_t e = pair_tbl[idx];
        const int w = static_cast<int>(e >> 40);
        acc |= (e & 0xFFFFFFFFull) << (64 - static_cast<int>(p - 8 * p0) - w);
        p += w;
        store_be64(out + p0, acc);
        const int64_t np0 = p >> 3;
        acc <<= 8 * (np0 - p0);
        p0 = np0;
      }
      if (j < stop) {  // odd block_size: one single-symbol deposit
        const uint32_t e = ent[data[j]];
        const int w = static_cast<int>(e >> 24);
        acc |= static_cast<uint64_t>(e & 0xFFFFu)
               << (64 - static_cast<int>(p - 8 * p0) - w);
        p += w;
        store_be64(out + p0, acc);
        const int64_t np0 = p >> 3;
        acc <<= 8 * (np0 - p0);
        p0 = np0;
      }
      i = stop;
    }
  }
  // tail seam: remaining whole blocks + tail symbols, byte-wise
  while (i + block_size <= hi_whole) {
    block_offsets_out[b++] = static_cast<uint32_t>(p);
    pack_block1_safe(data, i, i + block_size, ent, p, out);
    i += block_size;
  }
  if (i < hi)  // tail symbols past the last whole block (no offset entry)
    pack_block1_safe(data, i, hi, ent, p, out);
}

}  // namespace

// Full encode: frequencies -> widths -> codes -> MSB-first packed stream
// (incl. 2 zero read-ahead pad bytes) + per-block bit offsets.
//
// code_capacity must be >= 2*n + 16 bytes (worst case 16 bits/symbol).
// Returns 0; outputs: widths_out[256], code_bytes_out / *code_len_out (bytes
// used incl. pad), block_offsets_out[n / block_size], *total_bits_out.
int mht_encode(const uint8_t* data, int64_t n, int64_t block_size,
               uint8_t* widths_out, uint8_t* code_bytes_out,
               int64_t code_capacity, int64_t* code_len_out,
               uint32_t* block_offsets_out, int64_t* total_bits_out) {
  if (n <= 0) return -1;
  // 4 sub-histograms: the increment chain is otherwise serialized by
  // store-to-load forwarding on repeated symbols
  std::vector<int64_t> hist(4 * kNumSymbols, 0);
  {
    int64_t* h0 = hist.data();
    int64_t* h1 = h0 + kNumSymbols;
    int64_t* h2 = h1 + kNumSymbols;
    int64_t* h3 = h2 + kNumSymbols;
    int64_t i = 0;
    for (; i + 3 < n; i += 4) {
      ++h0[data[i]];
      ++h1[data[i + 1]];
      ++h2[data[i + 2]];
      ++h3[data[i + 3]];
    }
    for (; i < n; ++i) ++h0[data[i]];
  }
  int64_t freqs[kNumSymbols];
  for (int s = 0; s < kNumSymbols; ++s)
    freqs[s] = hist[s] + hist[kNumSymbols + s] + hist[2 * kNumSymbols + s] +
               hist[3 * kNumSymbols + s];
  int rc = mht_code_lengths(freqs, widths_out);
  if (rc) return rc;
  uint16_t codes[kNumSymbols];
  canonical_codes_impl(widths_out, codes);
  uint32_t ent[kNumSymbols];
  build_pack_entries(widths_out, codes, ent);

  int64_t total_bits = 0;
  for (int s = 0; s < kNumSymbols; ++s)
    total_bits += freqs[s] * static_cast<int64_t>(widths_out[s]);
  const int64_t total_bytes = (total_bits + 7) / 8 + 2;  // +2 read-ahead pad
  if (total_bytes > code_capacity) return -3;
  if (n / block_size > 0 && total_bits >= (1LL << 32)) return -7;  // u32 offsets

  std::memset(code_bytes_out, 0, total_bytes);
  std::vector<uint64_t> pair_tbl(1 << 16);
  build_pair_entries(ent, pair_tbl.data());
  const int64_t n_blocks = n / block_size;
  pack_chunk_or(data, 0, n, block_size, n_blocks, 0, ent, pair_tbl.data(),
                code_bytes_out, block_offsets_out, nullptr);
  *code_len_out = total_bytes;
  *total_bits_out = total_bits;
  return 0;
}

// Per-block delta coding (first byte literal, then wrapping differences).
int mht_delta_encode(const uint8_t* data, int64_t n, int64_t block_size,
                     uint8_t* out) {
  for (int64_t b = 0; b < n; b += block_size) {
    const int64_t end = std::min(b + block_size, n);
    out[b] = data[b];
    for (int64_t i = b + 1; i < end; ++i)
      out[i] = static_cast<uint8_t>(data[i] - data[i - 1]);
  }
  return 0;
}

// 2-D within-block predictor (container mode 3/4; core/delta.py mirror):
// row 0 is delta-left, rows below are delta-up, all wrapping mod 256.
// n must be a whole number of block_dim*block_dim blocks.
int mht_delta2d_encode(const uint8_t* data, int64_t n, int64_t block_dim,
                       uint8_t* out) {
  const int64_t bs = block_dim * block_dim;
  if (block_dim <= 0 || n % bs) return -1;
  for (int64_t b = 0; b < n; b += bs) {
    const uint8_t* p = data + b;
    uint8_t* o = out + b;
    o[0] = p[0];
    for (int64_t x = 1; x < block_dim; ++x)
      o[x] = static_cast<uint8_t>(p[x] - p[x - 1]);
    for (int64_t i = block_dim; i < bs; ++i)
      o[i] = static_cast<uint8_t>(p[i] - p[i - block_dim]);
  }
  return 0;
}

// Multithreaded encode. Two passes: (1) parallel per-chunk bit counts ->
// serial prefix -> absolute chunk start bits; (2) each thread packs its
// chunk into its own byte range of the shared zero-initialized buffer.
// A chunk whose start is not byte-aligned diverts its first (shared) byte
// into a side slot which is OR-merged serially after the join, so no two
// threads ever write the same byte concurrently.
static int encode_mt_impl(const uint8_t* data, int64_t n, int64_t block_size,
                          uint8_t* widths_out,
                          uint8_t* code_bytes_out, int64_t code_capacity,
                          int64_t* code_len_out, uint32_t* block_offsets_out,
                          int64_t* total_bits_out, int n_threads) {
  if (n <= 0) return -1;
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  // chunks aligned to block boundaries so each owns whole block offsets
  const int64_t n_blocks = n / block_size;
  int64_t blocks_per_chunk = (n_blocks + n_threads - 1) / n_threads;
  if (blocks_per_chunk == 0) blocks_per_chunk = 1;
  const int nc = n_blocks == 0
                     ? 1
                     : static_cast<int>((n_blocks + blocks_per_chunk - 1) /
                                        blocks_per_chunk);

  // pass 0: parallel frequency count (4 sub-histograms per chunk so the
  // increment chain is not serialized by store-to-load forwarding)
  std::vector<std::vector<int64_t>> freq_t(nc, std::vector<int64_t>(kNumSymbols, 0));
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nc; ++t) {
      ths.emplace_back([&, t]() {
        const int64_t lo = t * blocks_per_chunk * block_size;
        const int64_t hi =
            (t == nc - 1) ? n : std::min<int64_t>(n, (t + 1) * blocks_per_chunk * block_size);
        std::vector<int64_t> h(4 * kNumSymbols, 0);
        int64_t* h0 = h.data();
        int64_t* h1 = h0 + kNumSymbols;
        int64_t* h2 = h1 + kNumSymbols;
        int64_t* h3 = h2 + kNumSymbols;
        int64_t i = lo;
        for (; i + 3 < hi; i += 4) {
          ++h0[data[i]];
          ++h1[data[i + 1]];
          ++h2[data[i + 2]];
          ++h3[data[i + 3]];
        }
        for (; i < hi; ++i) ++h0[data[i]];
        auto& f = freq_t[t];
        for (int s = 0; s < kNumSymbols; ++s)
          f[s] = h0[s] + h1[s] + h2[s] + h3[s];
      });
    }
    for (auto& th : ths) th.join();
  }
  int64_t freqs[kNumSymbols] = {0};
  for (int t = 0; t < nc; ++t)
    for (int s = 0; s < kNumSymbols; ++s) freqs[s] += freq_t[t][s];

  int rc = mht_code_lengths(freqs, widths_out);
  if (rc) return rc;
  uint16_t codes[kNumSymbols];
  canonical_codes_impl(widths_out, codes);
  // every symbol present in the data has freq >= 1, hence width >= 1

  // chunk bit sums fall out of the per-chunk histograms (the original
  // pass 1 re-read all n bytes; this is O(256) per chunk instead)
  std::vector<int64_t> chunk_bits(nc, 0);
  for (int t = 0; t < nc; ++t) {
    int64_t b = 0;
    for (int s = 0; s < kNumSymbols; ++s)
      b += freq_t[t][s] * static_cast<int64_t>(widths_out[s]);
    chunk_bits[t] = b;
  }
  std::vector<int64_t> chunk_start(nc + 1, 0);
  for (int t = 0; t < nc; ++t) chunk_start[t + 1] = chunk_start[t] + chunk_bits[t];
  const int64_t total_bits = chunk_start[nc];
  if (n_blocks > 0 && total_bits >= (1LL << 32)) return -7;  // u32 offsets
  const int64_t total_bytes = (total_bits + 7) / 8 + 2;
  if (total_bytes > code_capacity) return -3;
  // no serial memset here: each pass-2 thread zeroes ITS OWN byte range
  // before packing (a serial memset of the output was ~10% of encode time)

  // pass 2: parallel pack (pair-table rolling packer, see pack_chunk_or);
  // the first partial byte of each chunk is shared with the previous
  // chunk's tail, so it is diverted to a side slot and OR-merged serially
  // after the join — no two threads ever write the same byte concurrently.
  // The 512 KB pair table is built once and read-shared by every thread.
  uint32_t ent[kNumSymbols];
  build_pack_entries(widths_out, codes, ent);
  std::vector<uint64_t> pair_tbl(1 << 16);
  build_pair_entries(ent, pair_tbl.data());
  std::vector<uint8_t> head_byte(nc, 0);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nc; ++t) {
      ths.emplace_back([&, t]() {
        const int64_t lo = t * blocks_per_chunk * block_size;
        const int64_t hi =
            (t == nc - 1) ? n : std::min<int64_t>(n, (t + 1) * blocks_per_chunk * block_size);
        // zero THIS thread's byte range first: every write below is an OR
        // (or a rolling store of accumulated bits) into its own bytes, so
        // per-thread zeroing composes exactly like the old global memset.
        // A chunk's shared first byte belongs to the PREVIOUS thread's
        // range (its tail bits live there; ours divert to head_byte).
        const int64_t z_lo = (chunk_start[t] + 7) / 8;
        const int64_t z_hi =
            (t == nc - 1) ? total_bytes : (chunk_start[t + 1] + 7) / 8;
        if (z_hi > z_lo)
          std::memset(code_bytes_out + z_lo, 0, z_hi - z_lo);
        pack_chunk_or(data, lo, hi, block_size, n_blocks, chunk_start[t],
                      ent, pair_tbl.data(), code_bytes_out,
                      block_offsets_out, &head_byte[t]);
      });
    }
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < nc; ++t) {
    if (chunk_start[t] & 7) code_bytes_out[chunk_start[t] >> 3] |= head_byte[t];
  }
  *code_len_out = total_bytes;
  *total_bits_out = total_bits;
  return 0;
}

int mht_encode_mt(const uint8_t* data, int64_t n, int64_t block_size,
                  uint8_t* widths_out, uint8_t* code_bytes_out,
                  int64_t code_capacity, int64_t* code_len_out,
                  uint32_t* block_offsets_out, int64_t* total_bits_out,
                  int n_threads) {
  return encode_mt_impl(data, n, block_size, widths_out,
                        code_bytes_out, code_capacity, code_len_out,
                        block_offsets_out, total_bits_out, n_threads);
}

// Stage 2 of the hybrid device encoder: merge per-block padded word rows
// (the stage-1 kernel's output, csrc/encode_rows.cu; each row = `row_words`
// u32 words holding that block's MSB-first packed bits, zero-padded) into one
// contiguous MSB-first byte stream with per-block bit offsets. This is the
// memcpy-speed counterpart of mht_encode_mt's pass 2: the bits are already
// packed per block, so the inner loop moves 32 bits per step instead of one
// symbol. Seam handling is the same head-byte OR trick — a chunk whose
// start bit is not byte-aligned diverts its first (shared) byte into a side
// slot merged serially after the join.
//
// Counterpart of the reference's single-threaded append encoder
// (HuffmanEncoder.cpp:211-276) for streams packed block-parallel on device.
int mht_merge_rows(const uint32_t* rows, const uint32_t* block_bits,
                   int64_t n_blocks, int64_t row_words,
                   uint8_t* code_bytes_out, int64_t code_capacity,
                   int64_t* code_len_out, uint32_t* block_offsets_out,
                   int64_t* total_bits_out, int n_threads) {
  if (n_blocks <= 0 || row_words <= 0) return -1;
  // serial prefix sum: absolute bit offset of every block
  std::vector<int64_t> offs(n_blocks + 1);
  offs[0] = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    if ((block_bits[b] + 31) / 32 > static_cast<uint64_t>(row_words))
      return -2;  // row too short for its bit count
    offs[b + 1] = offs[b] + block_bits[b];
  }
  const int64_t total_bits = offs[n_blocks];
  if (total_bits >= (1LL << 32)) return -7;  // u32 offsets overflow
  for (int64_t b = 0; b < n_blocks; ++b)
    block_offsets_out[b] = static_cast<uint32_t>(offs[b]);
  const int64_t total_bytes = (total_bits + 7) / 8 + 2;  // +2 read-ahead pad
  if (total_bytes > code_capacity) return -3;
  std::memset(code_bytes_out, 0, total_bytes);

  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  const int64_t per = (n_blocks + n_threads - 1) / std::max(1, n_threads);
  const int nc = static_cast<int>((n_blocks + per - 1) / per);

  std::vector<uint8_t> head_byte(nc, 0);
  std::vector<std::thread> ths;
  for (int t = 0; t < nc; ++t) {
    ths.emplace_back([&, t]() {
      const int64_t blo = t * per;
      const int64_t bhi = std::min<int64_t>(n_blocks, blo + per);
      int64_t bit_pos = offs[blo];
      // 128-bit accumulator: append up to 64 bits (two row words) per step
      // and flush 8 output bytes at a time — ~2x fewer dependent shift ops
      // per byte than a 64-bit acc with 32-bit flushes.
      unsigned __int128 acc = 0;
      int nbits = static_cast<int>(bit_pos & 7);  // lead-in zero bits
      int64_t byte_pos = bit_pos >> 3;
      bool first_partial = nbits != 0;
      for (int64_t b = blo; b < bhi; ++b) {
        const uint32_t* row = rows + b * row_words;
        int64_t left = block_bits[b];
        int64_t j = 0;
        while (left > 0) {
          if (left >= 64) {
            const uint64_t two =
                (static_cast<uint64_t>(row[j]) << 32) | row[j + 1];
            acc = (acc << 64) | two;
            nbits += 64;
            left -= 64;
            j += 2;
          } else {
            const int take = left >= 32 ? 32 : static_cast<int>(left);
            acc = (acc << take) |
                  (static_cast<uint64_t>(row[j]) >> (32 - take));
            nbits += take;
            left -= take;
            ++j;
          }
          // flush whole bytes; invariant: byte_pos*8 + nbits == bits appended
          if (first_partial && nbits >= 8) {
            nbits -= 8;
            head_byte[t] = static_cast<uint8_t>((acc >> nbits) & 0xFF);
            first_partial = false;
            ++byte_pos;
          }
          while (nbits >= 64) {
            nbits -= 64;
            const uint64_t be =
                __builtin_bswap64(static_cast<uint64_t>(acc >> nbits));
            std::memcpy(code_bytes_out + byte_pos, &be, 8);
            byte_pos += 8;
          }
        }
      }
      while (nbits >= 8) {  // drain whole tail bytes
        nbits -= 8;
        code_bytes_out[byte_pos++] =
            static_cast<uint8_t>((acc >> nbits) & 0xFF);
      }
      if (nbits > 0) {
        const uint8_t byte = static_cast<uint8_t>(
            (static_cast<uint32_t>(acc) << (8 - nbits)) & 0xFF);
        if (first_partial)
          head_byte[t] = byte;
        else
          code_bytes_out[byte_pos] = byte;
      }
    });
  }
  for (auto& th : ths) th.join();
  for (int t = 0; t < nc; ++t) {
    const int64_t start = offs[std::min<int64_t>(t * per, n_blocks)];
    if (start & 7) code_bytes_out[start >> 3] |= head_byte[t];
  }
  *code_len_out = total_bytes;
  *total_bits_out = total_bits;
  return 0;
}

}  // extern "C"
