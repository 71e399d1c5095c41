// K1's backward on Hopper: the dense table gradient of the embedding bag.
//
// Replaces the autodiff of the reference's single-shard embedding bag,
//   src/repro/models/embedding.py:138  embedding_bag_local (jnp.take and a
//   masked sum), which jax.grad transposes into a scatter-add of each bag's
//   gradient row into the rows the bag read.
// The TPU kernel hot_embedding_bag_pallas has no backward of its own.
//
// Function: out[r, :] = sum over the valid (bag, slot) pairs reading row r
//   of grad[bag, :], summed in fp32 (compensated) and written in grad's
//   dtype; out is dense [H, D], every row written.  ids [n_bags, P] int32
//   (the 3-D entry's [B, F, P] seen as B*F bags, feature f = bag % F);
//   pair i = bag * P + slot reads row ids[i] + offsets[f].  A pair that
//   reads row r twice in one bag counts twice; padding (id < 0), an
//   unrouted feature (offset < 0) and an id at or past the table read no
//   row.
// Row window: with a first row lo > 0, out is the gradient of rows
//   [lo, lo + H) of the combined table only, the rows one rank of a
//   row-sharded table holds (repro_torch.dist.sharded_embedding): a pair
//   whose row ids[i] + offsets[f] lies outside the window is dropped in
//   stage 1, and one inside adds into local row ids[i] + offsets[f] - lo.
//   The sort, the sums and the zero sweep then see only the window's pairs
//   and rows, in the same order as the whole table's launch sees them, so
//   the window's rows are bitwise rows [lo, lo + H) of that launch.  The
//   window is a template flag of stage 1's kernels (the subtraction and
//   the compare exist only in the windowed instances); lo = 0 needs
//   neither, since an id at or past H already reads no row.
//
// What bounds it: bytes.  The function reads the pooled gradient and the
// ids once and writes the dense gradient once: at the dlrm-rm2 train
// launch 0.22 + 0.44 + 16.64 GB, so the output write is nearly all of the
// bound, and every other byte moved is overhead.  The click log's ids are
// power-law, so one row can hold ~10^5 pairs, and 38% of the slots are
// padding.  Design, four stages, each a few kernels on the caller's stream
// with no host round trip (the pair count stays on the card):
//   1. Pairs.  A block takes 4,096 slots of the int32 ids (a warp 16
//      rounds of 32, its ids loaded at once), decides each slot's row
//      itself (offsets in 64 bits, the rules above) and emits only the
//      valid pairs as (row, flat index i), one 8-byte pair of 32-bit
//      values, compacted in flat-index order by a ballot a round and a
//      scan over the warps' and the tiles' counts (k1g_pairs_count,
//      k1g_scan_tiles, k1g_pairs_emit).  No int64 copy.
//   2. Sort.  An LSD radix sort of the pairs by row over ceil(log2 H) bits
//      only, in passes of at most 9 bits (27 bits: 3 passes).  A pass
//      counts each tile's digits (k1g_sort_count: shared atomics, a count
//      being the same in any order), scans the counts by digit, then by
//      tile, with every access a tile's contiguous row of counts
//      (k1g_sort_scan_up, _mid, _down), then scatters: each warp ranks its
//      512 keys by digit in position order (a ballot a digit bit gives the
//      lanes of equal digit), the tile is reordered in shared memory and
//      written in digit runs (k1g_sort_scatter).  A run is ~8 pairs, so
//      its ends share cache lines with other tiles' runs; a pair is one
//      8-byte store, not a row and an index in two arrays, which halves
//      those partly written lines (the sort ran 16% faster so at rm2 on
//      the H100).  The order that results is by row, then by flat index:
//      the order every row is summed in.
//   3. Sums.  Lane groups of L lanes each take a chunk of 64 * L sorted
//      pairs (16 * L below 2^25 slots, so that small launches fill the
//      card) and walk it in order.  A row of whole 16-byte vectors, at
//      most 8 of them, is one vector a lane (k1g_sum_async: the rm2, rmc1
//      and wide-deep deep launches; at D = 64 bf16 8 lanes, so a warp
//      loads 4 gradient rows in one instruction): the rows go to shared
//      memory by cp.async two batches of 8 ahead of their adds, so a group
//      keeps 16 rows in flight with no registers held for them.  Any other
//      row (k1g_sum) is one element a lane, 32 lanes over the columns
//      with 8 elements in flight; at D = 1 (wide-deep's wide launch) a
//      group is one lane, so every lane walks a chunk of its own.  Only
//      the cells' rows are tuned; the rest are right, not fast.  A run
//      inside the chunk is written to out; a run crossing the chunk's end
//      leaves its pieces in a float32 scratch, and the chunk where it
//      starts joins them in chunk order and writes the row (k1g_join,
//      which finds how far the run reaches 32 chunks at a time).  So a row
//      of 10^5 pairs is summed by many groups at once, joined in a fixed
//      order.  The first chunk of a run marks the row in a bitmap (H bits,
//      16 MB at rm2, in L2).
//   4. Write.  A warp takes 32 rows (one bitmap word) and writes zeros to
//      the rows the bitmap leaves untouched, in 16-byte coalesced stores
//      (k1g_zero; rows under 16 bytes, as at D = 1, are stored 16 / row
//      bytes at a time, by a grid the SMs hold at once).  So every row of
//      out is written exactly once, by the kernels: no fill of the output.
//      (Running the sweep beside the sums, on a second stream, made both
//      slower on the H100: the random row reads and the write stream
//      contend for the same memory.)
// Every row is summed in one fixed order (sorted order inside a chunk, the
// chunks' pieces in chunk order), compensated (Neumaier: a hot row adds
// thousands of gradient rows that largely cancel), with no atomics on any
// sum: two launches on the same inputs are bitwise equal.  (The bitmap's
// atomicOr sets bits, whatever the order.)  Row and output offsets are
// 64-bit (wide-deep's deep table has 2.56e9 elements); the flat pair index
// is 32-bit (the wrapper refuses 2^31 slots or more).
//
// Plain C interface, loaded with ctypes: repro_embedding_bag_grad_layout
// sizes the scratch, repro_embedding_bag_grad runs the chosen stages on
// the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kWarps = 8;  // warps a block, every kernel
constexpr int kThreads = kWarps * 32;
constexpr int kItems = 16;                // slots or pairs a lane, stages 1-2
constexpr int kTile = kThreads * kItems;  // 4,096 slots or pairs a block
constexpr int kWarpSpan = 32 * kItems;    // a warp's share of a tile
constexpr int kDigitBits = 9;             // widest radix digit
constexpr int kDigits = 1 << kDigitBits;
constexpr int kScanThreads = 1024;
constexpr int kScanTiles = 64;  // tiles a block of the digit counts' scan
constexpr int kChunkPerLane = 64;  // sorted pairs a group takes, per lane
constexpr int kShortChunkPerLane = 16;  // the same, below kLongChunkSlots
constexpr int64_t kLongChunkSlots = int64_t{1} << 25;
constexpr int kRowsInFlight = 8;   // gradient rows a group loads at once, C = 1
constexpr int kMaxDevices = 64;
constexpr int kZeroBlocksAnSm = 8;  // the zero sweep's grid, kRowsAVector
constexpr unsigned kFull = 0xffffffffu;

// The stages a call runs; each needs what the ones before it left.
enum Stage { kPairs = 1, kSort = 2, kSum = 4, kWrite = 8 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// s + x into the sum s and its running compensation e (Neumaier): the
// rounding error of each add is kept in e; the sum is s + e.
__device__ __forceinline__ void add_comp(float& s, float& e, float x) {
  const float t = s + x;
  e += fabsf(s) >= fabsf(x) ? (s - t) + x : (x - t) + s;
  s = t;
}

// The row of pair i of an array of (row, flat index) pairs.
__device__ __forceinline__ int32_t row_at(const int2* pairs, int64_t i) {
  return __ldg(reinterpret_cast<const int32_t*>(pairs) + 2 * i);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// V elements of T moved as one aligned load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Exclusive prefix sum of one int a thread over the block, in thread
// order; `total` gets the block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_sum(int v, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;  // inclusive
  }
  __syncthreads();
  total = warp_sums[n_warps - 1];
  const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

// ---------------------------------------------------------------------------
// 1. pairs
// ---------------------------------------------------------------------------

struct PairsArgs {
  const int32_t* ids;
  const int64_t* offsets;  // null: one feature, offset 0
  int64_t n;               // slots, < 2^31
  int32_t P;
  int32_t F;
  int32_t H;   // the rows of the output (the window's with kWindow)
  int64_t lo;  // the window's first row in the combined table (kWindow)
};

// The row slot i (holding `id`) reads, if any (a local row of the window
// with kWindow).
template <bool kWindow>
__device__ __forceinline__ bool slot_row(const PairsArgs& a, int64_t i,
                                         int32_t id, int32_t& row) {
  if (i >= a.n || id < 0) return false;
  int64_t r = id;
  if (a.offsets != nullptr) {
    const uint32_t f = (static_cast<uint32_t>(i) / static_cast<uint32_t>(a.P))
                       % static_cast<uint32_t>(a.F);
    const int64_t off = __ldg(a.offsets + f);
    if (off < 0) return false;
    r += off;
  }
  if constexpr (kWindow) {
    r -= a.lo;
    if (r < 0) return false;
  }
  if (r >= a.H) return false;
  row = static_cast<int32_t>(r);
  return true;
}

// A warp's kWarpSpan slots of the tile from `base`, slot lane of round k:
// the rows they read (rows[k]) and which of them read one (bit k of
// `valid`).
template <bool kWindow>
__device__ __forceinline__ void warp_slots(const PairsArgs& a, int64_t base,
                                           int lane, int32_t (&rows)[kItems],
                                           unsigned& valid) {
  int32_t id[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + 32 * k + lane;
    id[k] = i < a.n ? __ldg(a.ids + i) : -1;
  }
  valid = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (slot_row<kWindow>(a, base + 32 * k + lane, id[k], rows[k]))
      valid |= 1u << k;
}

// The valid pairs of each tile of kTile slots -> tile_count[tile].
template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
    k1g_pairs_count(PairsArgs a, int32_t* __restrict__ tile_count) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t rows[kItems];
  unsigned valid;
  warp_slots<kWindow>(
      a, static_cast<int64_t>(blockIdx.x) * kTile + warp * kWarpSpan, lane,
      rows, valid);
  const int count = __reduce_add_sync(kFull, __popc(valid));
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_count[w];
    tile_count[blockIdx.x] = t;
  }
}

// Exclusive prefix sum, in place, of the tiles' pair counts; their total
// (the valid pairs) to *total.  One block.
__global__ void __launch_bounds__(kScanThreads)
    k1g_scan_tiles(int32_t* __restrict__ c, int64_t len,
                   int32_t* __restrict__ total_out) {
  int carry = 0;
  for (int64_t s = 0; s < len; s += kScanThreads) {
    const int64_t i = s + threadIdx.x;
    const int v = i < len ? c[i] : 0;
    int total;
    const int e = block_exclusive_sum(v, total);
    if (i < len) c[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

// The valid pairs of each tile written in flat-index order from
// tile_start[tile]: pairs[j] = (row, flat slot index).
template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
    k1g_pairs_emit(PairsArgs a, const int32_t* __restrict__ tile_start,
                   int2* __restrict__ pairs) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       warp * kWarpSpan;
  int32_t rows[kItems];
  unsigned valid;
  warp_slots<kWindow>(a, base, lane, rows, valid);
  const int count = __reduce_add_sync(kFull, __popc(valid));
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  int at = tile_start[blockIdx.x];
  for (int w = 0; w < warp; ++w) at += warp_count[w];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned round = __ballot_sync(kFull, (valid >> k) & 1u);
    if ((round >> lane) & 1u) {
      const int j = at + __popc(round & lanes_below(lane));
      pairs[j] = make_int2(rows[k], static_cast<int32_t>(base + 32 * k + lane));
    }
    at += __popc(round);
  }
}

// ---------------------------------------------------------------------------
// 2. sort
// ---------------------------------------------------------------------------

__device__ __forceinline__ int digit_of(int32_t key, int shift, int width) {
  return (static_cast<uint32_t>(key) >> shift) & ((1u << width) - 1u);
}

// The live lanes of the warp whose digit equals this lane's: one ballot a
// digit bit (a warp multi-split; cheaper than __match_any_sync here).
__device__ __forceinline__ unsigned digit_peers(int d, bool live, int width) {
  unsigned peers = __ballot_sync(kFull, live);
  for (int b = 0; b < width; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned m = __ballot_sync(kFull, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Each tile's digit counts -> counts[tile * kDigits + digit].
__global__ void __launch_bounds__(kThreads)
    k1g_sort_count(const int2* __restrict__ pairs,
                   const int32_t* __restrict__ n_pairs, int shift, int width,
                   int32_t* __restrict__ counts) {
  __shared__ int hist[kDigits];
  const int m = *n_pairs;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  if (tile0 >= m) return;
  for (int d = threadIdx.x; d < kDigits; d += kThreads) hist[d] = 0;
  __syncthreads();
  int32_t key[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = tile0 + k * kThreads + threadIdx.x;
    key[k] = i < m ? __ldg(pairs + i).x : -1;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)  // a count is the same in any order
    if (key[k] >= 0) atomicAdd(hist + digit_of(key[k], shift, width), 1);
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kThreads)
    counts[blockIdx.x * kDigits + d] = hist[d];
}

// The scan of the digit counts into where each (tile, digit) run starts in
// the pass's output: by digit, then by tile.  Three kernels, every access
// a tile's row of kDigits counts: (up) each block of kScanTiles tiles sums
// its rows; (mid) one block scans those sums over the blocks, digit by
// digit, and the digits' totals; (down) each block writes its tiles'
// starts in place of their counts.
__global__ void __launch_bounds__(kThreads)
    k1g_sort_scan_up(const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ n_pairs,
                     int32_t* __restrict__ sums) {
  const int64_t tiles = (*n_pairs + kTile - 1) / kTile;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kScanTiles;
  if (t0 >= tiles) return;
  const int64_t t1 = t0 + kScanTiles < tiles ? t0 + kScanTiles : tiles;
  for (int d = threadIdx.x; d < kDigits; d += kThreads) {
    int sum = 0;
    for (int64_t t = t0; t < t1; ++t) sum += __ldg(counts + t * kDigits + d);
    sums[blockIdx.x * kDigits + d] = sum;
  }
}

__global__ void __launch_bounds__(kDigits)
    k1g_sort_scan_mid(int32_t* __restrict__ sums,
                      const int32_t* __restrict__ n_pairs) {
  const int64_t tiles = (*n_pairs + kTile - 1) / kTile;
  const int64_t blocks = (tiles + kScanTiles - 1) / kScanTiles;
  const int d = threadIdx.x;
  int run = 0;
  for (int64_t b = 0; b < blocks; ++b) {
    const int c = sums[b * kDigits + d];
    sums[b * kDigits + d] = run;
    run += c;
  }
  int total;
  const int base = block_exclusive_sum(run, total);  // the smaller digits'
  for (int64_t b = 0; b < blocks; ++b) sums[b * kDigits + d] += base;
}

__global__ void __launch_bounds__(kThreads)
    k1g_sort_scan_down(int32_t* __restrict__ counts,
                       const int32_t* __restrict__ n_pairs,
                       const int32_t* __restrict__ sums) {
  const int64_t tiles = (*n_pairs + kTile - 1) / kTile;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kScanTiles;
  if (t0 >= tiles) return;
  const int64_t t1 = t0 + kScanTiles < tiles ? t0 + kScanTiles : tiles;
  for (int d = threadIdx.x; d < kDigits; d += kThreads) {
    int run = sums[blockIdx.x * kDigits + d];
    for (int64_t t = t0; t < t1; ++t) {
      const int c = counts[t * kDigits + d];
      counts[t * kDigits + d] = run;
      run += c;
    }
  }
}

// One stable scatter pass: a tile's pairs go to their digit's run, after
// the pairs of smaller digits and of the same digit in earlier tiles;
// starts[tile * kDigits + digit] is where that run starts.
__global__ void __launch_bounds__(kThreads, 3)
    k1g_sort_scatter(const int2* __restrict__ in, int2* __restrict__ out,
                     const int32_t* __restrict__ n_pairs, int shift, int width,
                     const int32_t* __restrict__ starts) {
  __shared__ unsigned short warp_digit[kWarps][kDigits];
  __shared__ int digit_count[kDigits];  // this tile's; later the shift out
  __shared__ int digit_start[kDigits];  // where a digit starts in the tile
  __shared__ int2 tile[kTile];
  const int m = *n_pairs;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  if (tile0 >= m) return;
  const int n_tile = m - tile0 < kTile ? static_cast<int>(m - tile0) : kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = warp * kWarpSpan + lane;  // this lane's first position
  for (int j = threadIdx.x; j < kWarps * kDigits; j += kThreads)
    (&warp_digit[0][0])[j] = 0;
  __syncthreads();

  // rank inside the warp's 512 pairs, by digit, in position order
  int2 pair[kItems];
  unsigned short rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    pair[k] = first + 32 * k < n_tile ? __ldg(in + tile0 + first + 32 * k)
                                      : make_int2(-1, 0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool live = pair[k].x >= 0;
    const int d = live ? digit_of(pair[k].x, shift, width) : 0;
    const unsigned peers = digit_peers(d, live, width);
    const int before = live ? warp_digit[warp][d] : 0;
    rank[k] = static_cast<unsigned short>(
        before + __popc(peers & lanes_below(lane)));
    __syncwarp();
    if (live && lane == __ffs(peers) - 1)
      warp_digit[warp][d] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // each digit: the warps' exclusive prefix, and the tile's count
  for (int d = threadIdx.x; d < kDigits; d += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_digit[w][d];
      warp_digit[w][d] = static_cast<unsigned short>(run);
      run += c;
    }
    digit_count[d] = run;
  }
  __syncthreads();
  static_assert(kDigits == 2 * kThreads, "two digits a thread");
  const int d2 = 2 * threadIdx.x;  // the two digits this thread keeps
  {
    int total;
    const int e = block_exclusive_sum(digit_count[d2] + digit_count[d2 + 1],
                                      total);
    digit_start[d2] = e;
    digit_start[d2 + 1] = e + digit_count[d2];
  }
  __syncthreads();

  // the tile in digit order, in shared memory
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (pair[k].x >= 0) {
      const int d = digit_of(pair[k].x, shift, width);
      tile[digit_start[d] + warp_digit[warp][d] + rank[k]] = pair[k];
    }
  }
  // the shift from the tile to the output, digit by digit
  const int32_t* start = starts + static_cast<int64_t>(blockIdx.x) * kDigits;
  digit_count[d2] = __ldg(start + d2) - digit_start[d2];
  digit_count[d2 + 1] = __ldg(start + d2 + 1) - digit_start[d2 + 1];
  __syncthreads();
  for (int j = threadIdx.x; j < n_tile; j += kThreads) {
    const int2 q = tile[j];
    out[digit_count[digit_of(q.x, shift, width)] + j] = q;
  }
}

// ---------------------------------------------------------------------------
// 3. sums
// ---------------------------------------------------------------------------

struct SumArgs {
  const int2* pairs;  // (row, flat index), sorted by row, then flat index
  const int32_t* n_pairs;
  const void* grad;
  void* out;
  float* part;  // [2, n_chunks, D]: pieces that begin before the chunk, and
                // pieces of runs that start in it and cross its end
  uint32_t* touched;  // H bits
  int64_t n_chunks;
  int64_t chunk_len;  // sorted pairs a group takes
  int32_t P;
  int32_t D;
};

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&s)[V],
                                          const float (&e)[V]) {
  Vec<T, V> v;
#pragma unroll
  for (int j = 0; j < V; ++j) v.v[j] = from_f32<T>(s[j] + e[j]);
  *reinterpret_cast<Vec<T, V>*>(p) = v;
}

// Pass 1 for the rows k1g_sum_async does not take: one element a lane, L
// lanes over the columns (L = 32, column blocks of 32 along the grid's y),
// or L = 1 at D = 1, where every lane walks a chunk of its own.  A group
// loads kRowsInFlight gradient elements at once, the next batch's keys
// loading meanwhile.  Grid: x = blocks of kWarps * (32 / L) chunks, y =
// column blocks.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 2) k1g_sum(SumArgs a) {
  constexpr int kGroups = 32 / L;
  constexpr int kU = kRowsInFlight;            // elements in flight
  constexpr int kBatch = L > kU ? L : kU;      // pairs whose keys load at once
  constexpr int kKeys = kBatch / L;            // keys a lane loads a batch
  const int lane = threadIdx.x & 31;
  const int g_lane = lane % L;
  const unsigned g_mask =
      L == 32 ? kFull : ((1u << L) - 1u) << (lane - g_lane);
  const int64_t chunk =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
          kGroups + lane / L;
  const int m = *a.n_pairs;
  const int64_t s = chunk * a.chunk_len;
  if (s >= m) return;  // the whole group leaves together
  const int64_t e = s + a.chunk_len < m ? s + a.chunk_len : m;
  const int D = a.D;
  const int col = blockIdx.y * L + g_lane;
  const T* grad = static_cast<const T*>(a.grad);
  T* out = static_cast<T*>(a.out);
  const uint32_t P = static_cast<uint32_t>(a.P);

  // the run in progress: its row, whether it began before the chunk, and
  // whether it has a pair in the chunk yet
  int32_t cur = s > 0 ? row_at(a.pairs, s - 1) : -1;
  bool head = true;
  bool has = false;
  float acc = 0.f, err = 0.f;

  auto flush = [&](bool crosses) {
    if (col < D) {
      if (head || crosses)
        a.part[((head ? 0 : a.n_chunks) + chunk) * D + col] = acc + err;
      else
        out[static_cast<int64_t>(cur) * D + col] = from_f32<T>(acc + err);
    }
    // the chunk where the run starts marks its row
    if (!head && blockIdx.y == 0 && g_lane == 0)
      atomicOr(a.touched + (cur >> 5), 1u << (cur & 31));
  };
  // the keys and flat indices of the batch from `base`: the next batch's
  // load while this one's rows do
  auto load_keys = [&](int64_t base, int32_t (&kb)[kKeys],
                       int32_t (&ib)[kKeys]) {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int64_t i = base + g_lane + L * r;
      const int2 q = i < e ? __ldg(a.pairs + i) : make_int2(-1, 0);
      kb[r] = q.x;
      ib[r] = q.y;
    }
  };

  int32_t kb[kKeys], ib[kKeys];
  load_keys(s, kb, ib);
  for (int64_t base = s; base < e; base += kBatch) {
    int32_t nk[kKeys], ni[kKeys];
    load_keys(base + kBatch, nk, ni);
#pragma unroll
    for (int q = 0; q < kBatch; q += kU) {
      int32_t kk[kU];
      T x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int p = q + u;  // the pair's place in the batch
        kk[u] = __shfl_sync(g_mask, kb[p / L], p % L, L);
        const int32_t flat = __shfl_sync(g_mask, ib[p / L], p % L, L);
        x[u] = kk[u] >= 0 && col < D
                   ? __ldg(grad + static_cast<int64_t>(
                                      static_cast<uint32_t>(flat) / P) * D +
                           col)
                   : from_f32<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (kk[u] < 0) break;  // past the chunk's end
        if (kk[u] != cur) {
          if (has) flush(false);
          cur = kk[u];
          head = false;
          acc = err = 0.f;
        }
        has = true;
        add_comp(acc, err, to_f32(x[u]));
      }
    }
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      kb[r] = nk[r];
      ib[r] = ni[r];
    }
  }
  flush(e < m && row_at(a.pairs, e) == cur);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pass 1 where a row is one 16-byte vector a lane of L <= 8 lanes: the
// same walk as k1g_sum, with the gradient rows copied into shared memory
// by cp.async two batches of kRowsInFlight ahead of their adds, so a group
// keeps 16 rows in flight with no registers held for them (at D = 64 bf16
// a warp has 64 rows, 8 KB, in flight).  Each lane reads back only the
// vectors it copied, so no barrier is needed.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 3) k1g_sum_async(SumArgs a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kGroups = 32 / L;
  constexpr int kU = kRowsInFlight;   // pairs a batch
  constexpr int kKeys = kU / L;       // keys a lane loads a batch
  static_assert(L <= kU, "a batch is kU pairs");
  extern __shared__ int4 ring[];      // [2 stages][kU][kThreads] vectors
  const int lane = threadIdx.x & 31;
  const int g_lane = lane % L;
  const unsigned g_mask =
      L == 32 ? kFull : ((1u << L) - 1u) << (lane - g_lane);
  const int64_t chunk =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
          kGroups + lane / L;
  const int m = *a.n_pairs;
  const int64_t s = chunk * a.chunk_len;
  if (s >= m) return;  // the whole group leaves together
  const int64_t e = s + a.chunk_len < m ? s + a.chunk_len : m;
  const int D = a.D;
  const int col = g_lane * V;
  const T* grad = static_cast<const T*>(a.grad);
  T* out = static_cast<T*>(a.out);
  const uint32_t P = static_cast<uint32_t>(a.P);

  int32_t cur = s > 0 ? row_at(a.pairs, s - 1) : -1;
  bool head = true;
  bool has = false;
  float acc[V], err[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = err[j] = 0.f;

  auto flush = [&](bool crosses) {
    if (col < D) {
      if (head || crosses) {
        float* dst = a.part + ((head ? 0 : a.n_chunks) + chunk) * D + col;
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = acc[j] + err[j];
      } else {
        store_vec<T, V>(out + static_cast<int64_t>(cur) * D + col, acc, err);
      }
    }
    if (!head && g_lane == 0)
      atomicOr(a.touched + (cur >> 5), 1u << (cur & 31));
  };
  auto load_keys = [&](int64_t base, int32_t (&kb)[kKeys],
                       int32_t (&ib)[kKeys]) {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int64_t i = base + g_lane + L * r;
      const int2 q = i < e ? __ldg(a.pairs + i) : make_int2(-1, 0);
      kb[r] = q.x;
      ib[r] = q.y;
    }
  };
  // the batch's rows into `stage`, then one commit group (empty past the
  // chunk's end, so that the groups count batches)
  auto issue = [&](const int32_t (&kb)[kKeys], const int32_t (&ib)[kKeys],
                   int stage) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int32_t k = __shfl_sync(g_mask, kb[u / L], u % L, L);
      const int32_t flat = __shfl_sync(g_mask, ib[u / L], u % L, L);
      if (k >= 0 && col < D)
        cp_async16(ring + (stage * kU + u) * kThreads + threadIdx.x,
                   grad + static_cast<int64_t>(
                              static_cast<uint32_t>(flat) / P) * D + col);
    }
    cp_async_commit();
  };

  int32_t k0[kKeys], i0[kKeys], k1[kKeys], i1[kKeys], k2[kKeys], i2[kKeys];
  load_keys(s, k0, i0);
  load_keys(s + kU, k1, i1);
  issue(k0, i0, 0);
  issue(k1, i1, 1);
  load_keys(s + 2 * kU, k2, i2);
  int stage = 0;
  for (int64_t base = s; base < e; base += kU) {
    cp_async_wait<1>();  // this batch's rows are in `stage`
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int32_t k = __shfl_sync(g_mask, k0[u / L], u % L, L);
      if (k < 0) break;  // past the chunk's end
      Vec<T, V> x;
      if (col < D) {
        const int4 q = ring[(stage * kU + u) * kThreads + threadIdx.x];
        memcpy(&x, &q, sizeof(x));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x.v[j] = from_f32<T>(0.f);
      }
      if (k != cur) {
        if (has) flush(false);
        cur = k;
        head = false;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = err[j] = 0.f;
      }
      has = true;
#pragma unroll
      for (int j = 0; j < V; ++j) add_comp(acc[j], err[j], to_f32(x.v[j]));
    }
    issue(k2, i2, stage);  // two batches on, into the stage just read
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      k0[r] = k1[r];
      i0[r] = i1[r];
      k1[r] = k2[r];
      i1[r] = i2[r];
    }
    load_keys(base + 3 * kU, k2, i2);
    stage ^= 1;
  }
  cp_async_wait<0>();
  flush(e < m && row_at(a.pairs, e) == cur);
}

// Pass 2: the chunk where a run crossing its end starts adds the pieces of
// the chunks the run reaches into, in chunk order, and writes the row.  A
// warp takes 32 chunks: each lane finds whether its chunk owns such a run,
// then the warp joins the owned ones in turn, lanes over the columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k1g_join(const int2* __restrict__ pairs,
             const int32_t* __restrict__ n_pairs, T* __restrict__ out,
             const float* __restrict__ part, int64_t n_chunks, int64_t chunk_len,
             int32_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32 +
      lane;
  const int m = *n_pairs;
  const int64_t s = chunk * chunk_len;
  const int64_t e = s + chunk_len;
  bool owns = false;
  int32_t row = -1;
  if (e < m) {  // the last chunk (or past it): nothing crosses its end
    row = row_at(pairs, e - 1);
    owns = row_at(pairs, e) == row && (s == 0 || row_at(pairs, s - 1) != row);
  }
  for (unsigned todo = __ballot_sync(kFull, owns); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int64_t c0 = __shfl_sync(kFull, chunk, src);
    const int32_t r = __shfl_sync(kFull, row, src);
    // the chunks the run reaches, (c0, last], looked up 32 at a time
    int64_t last = c0 + 1;
    for (;;) {
      const int64_t c = last + 1 + lane;
      const unsigned more = __ballot_sync(
          kFull, c * chunk_len < m && row_at(pairs, c * chunk_len) == r);
      const int n = ~more == 0u ? 32 : __ffs(~more) - 1;
      last += n;
      if (n < 32) break;
    }
    T* dst = out + static_cast<int64_t>(r) * D;
    for (int col = lane; col < D; col += 32) {
      float acc = part[(n_chunks + c0) * D + col];
      float err = 0.f;
      for (int64_t c2 = c0 + 1; c2 <= last; ++c2)
        add_comp(acc, err, part[c2 * D + col]);
      dst[col] = from_f32<T>(acc + err);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. write
// ---------------------------------------------------------------------------

// How the zero sweep stores a row of `row_bytes`.
enum ZeroMode {
  kElements = 0,  // one element a store
  kRowVectors = 1,  // 16-byte stores, row_bytes / 16 a row
  kRowsAVector = 2,  // 16-byte stores of 16 / row_bytes whole rows each
};

template <typename T>
__device__ __forceinline__ T zero() {
  return from_f32<T>(0.f);
}
template <>
__device__ __forceinline__ int4 zero<int4>() {
  return make_int4(0, 0, 0, 0);
}

// Zeros into the rows r0 .. r0 + rows - 1 that `word` leaves unmarked, one
// element a store, by the warp.
template <typename T>
__device__ __forceinline__ void zero_elements(T* out, int64_t r0, int rows,
                                             uint32_t word, int D,
                                             int lane) {
  const int total = rows * D;
  // element k = lane + 32 * step: row k / D, column k % D, stepped without
  // a division
  const int step_r = 32 / D;
  const int step_c = 32 % D;
  int r = lane / D;
  int c = lane % D;
  T* base = out + r0 * D;
  for (int k = lane; k < total; k += 32) {
    if (!((word >> r) & 1u)) base[static_cast<int64_t>(r) * D + c] = zero<T>();
    c += step_c;
    r += step_r;
    if (c >= D) {
      c -= D;
      ++r;
    }
  }
}

// Zeros into every row the bitmap leaves unmarked (every row when
// `touched` is null).  Warps take words of 32 rows in turn over the grid,
// 32 / units of them at once in kRowsAVector.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    k1g_zero(T* __restrict__ out, const uint32_t* __restrict__ touched,
             int64_t H, int32_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t n_words = (H + 31) / 32;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  if constexpr (kMode == kRowsAVector) {
    const int rpu = 16 / row_bytes;  // rows a store
    const int units = 32 / rpu;      // stores a word
    const int words = 32 / units;    // words a warp at once
    for (int64_t w0 = warp0 * words; w0 < n_words; w0 += n_warps * words) {
      const int64_t w = w0 + lane / units;
      const int u = lane % units;
      if (w >= n_words) continue;
      const int64_t r0 = w * 32;
      const uint32_t word = touched != nullptr ? __ldg(touched + w) : 0u;
      const uint32_t bits = (word >> (u * rpu)) & ((1u << rpu) - 1u);
      if (H - r0 >= 32 && bits == 0) {
        reinterpret_cast<int4*>(out + r0 * D)[u] = zero<int4>();
      } else {
        for (int r = u * rpu; r < (u + 1) * rpu && r0 + r < H; ++r)
          if (!((word >> r) & 1u))
            for (int c = 0; c < D; ++c) out[(r0 + r) * D + c] = zero<T>();
      }
    }
  } else {
    for (int64_t w = warp0; w < n_words; w += n_warps) {
      const int64_t r0 = w * 32;
      const int rows = H - r0 < 32 ? static_cast<int>(H - r0) : 32;
      const uint32_t word = touched != nullptr ? __ldg(touched + w) : 0u;
      if (word == kFull) continue;
      if constexpr (kMode == kRowVectors)
        zero_elements<int4>(reinterpret_cast<int4*>(out), r0, rows, word,
                            row_bytes / 16, lane);
      else
        zero_elements<T>(out, r0, rows, word, D, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int64_t align256(int64_t x) { return (x + 255) & ~int64_t{255}; }

// The launch geometry and scratch layout of one call.
struct Plan {
  int64_t n, H, D, esize;
  bool vec;      // rows of whole 16-byte vectors
  bool async;    // vector rows of at most kRowsInFlight vectors: k1g_sum_async
  int L;         // lanes a row (a vector or an element each) a column block
  int col_blocks;
  int bits, passes, width;
  int64_t tiles;     // of kTile slots or pairs
  int64_t n_chunks;  // chunks of the sums pass, over the slots (a bound)
  int64_t chunk_len;
  // byte offsets into the scratch
  int64_t o_meta, o_tile, o_pairs[2], o_counts, o_sums, o_bits,
      o_part, bytes;
};

Plan make_plan(int64_t n, int64_t H, int64_t D, int64_t esize) {
  Plan p{};
  p.n = n;
  p.H = H;
  p.D = D;
  p.esize = esize;
  p.vec = (D * esize) % 16 == 0;
  const int64_t nv = D * esize / 16;  // vectors in a row, if vec
  p.async = p.vec && nv <= kRowsInFlight;
  if (p.async) {
    p.L = 1;
    while (p.L < nv) p.L <<= 1;
  } else {
    p.L = D == 1 ? 1 : 32;
  }
  p.col_blocks = p.async ? 1 : static_cast<int>((D + p.L - 1) / p.L);
  p.bits = 0;
  while ((int64_t{1} << p.bits) < H) ++p.bits;
  p.passes = (p.bits + kDigitBits - 1) / kDigitBits;
  p.width = p.passes > 0 ? (p.bits + p.passes - 1) / p.passes : 0;
  p.tiles = (n + kTile - 1) / kTile;
  // short chunks where there are few pairs, so that enough groups run
  p.chunk_len = int64_t{n >= kLongChunkSlots ? kChunkPerLane
                                             : kShortChunkPerLane} * p.L;
  p.n_chunks = (n + p.chunk_len - 1) / p.chunk_len;
  int64_t at = 0;
  auto take = [&](int64_t bytes) {
    const int64_t o = at;
    at += align256(bytes);
    return o;
  };
  p.o_meta = take(16);
  p.o_tile = take(4 * (p.tiles + 1));
  p.o_pairs[0] = take(8 * n);
  p.o_pairs[1] = take(8 * n);
  p.o_counts = take(4 * int64_t{kDigits} * p.tiles);
  p.o_sums = take(4 * int64_t{kDigits} * ((p.tiles + kScanTiles - 1) / kScanTiles));
  p.o_bits = take(4 * ((H + 31) / 32));
  p.o_part = take(4 * 2 * p.n_chunks * D);
  p.bytes = at;
  return p;
}

// The buffer that holds the sorted pairs (0 or 1).
int sorted_buffer(const Plan& p) { return p.passes % 2; }

template <typename T, int L>
cudaError_t launch_sum(const Plan& p, const SumArgs& a, cudaStream_t st) {
  constexpr int64_t kChunksABlock = int64_t{kWarps} * (32 / L);
  const int64_t blocks = (p.n_chunks + kChunksABlock - 1) / kChunksABlock;
  if (blocks > 0x7fffffff || p.col_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(p.col_blocks));
  k1g_sum<T, L><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

constexpr int kAsyncSmem = 2 * kRowsInFlight * kThreads * 16;

template <typename T, int L>
cudaError_t launch_sum_async(const Plan& p, const SumArgs& a, int device,
                             cudaStream_t st) {
  // the shared-memory size opted into, once a device
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1g_sum_async<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kAsyncSmem);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  constexpr int64_t kChunksABlock = int64_t{kWarps} * (32 / L);
  const int64_t blocks = (p.n_chunks + kChunksABlock - 1) / kChunksABlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  k1g_sum_async<T, L><<<static_cast<unsigned>(blocks), kThreads, kAsyncSmem,
                        st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sums(const Plan& p, const SumArgs& a, int device,
                        cudaStream_t st) {
  if (p.async) {
    switch (p.L) {
      case 1: return launch_sum_async<T, 1>(p, a, device, st);
      case 2: return launch_sum_async<T, 2>(p, a, device, st);
      case 4: return launch_sum_async<T, 4>(p, a, device, st);
      default: return launch_sum_async<T, 8>(p, a, device, st);
    }
  }
  return p.L == 1 ? launch_sum<T, 1>(p, a, st) : launch_sum<T, 32>(p, a, st);
}

int sm_count(int device) {
  static int counts[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    counts[device] = 132;
  return counts[device];
}

template <typename T>
cudaError_t reduce(const Plan& p, char* scratch, const void* grad, void* out,
                   int32_t P, int stages, int device, cudaStream_t st) {
  const int b = sorted_buffer(p);
  const int32_t* m = reinterpret_cast<const int32_t*>(scratch + p.o_meta);
  const int2* pairs = reinterpret_cast<const int2*>(scratch + p.o_pairs[b]);
  uint32_t* touched = reinterpret_cast<uint32_t*>(scratch + p.o_bits);
  cudaError_t e;
  if (stages & kSum) {
    e = cudaMemsetAsync(touched, 0, 4 * ((p.H + 31) / 32), st);
    if (e != cudaSuccess) return e;
  }
  if ((stages & kSum) && p.n_chunks > 0) {
    SumArgs a{pairs,
              m,
              grad,
              out,
              reinterpret_cast<float*>(scratch + p.o_part),
              touched,
              p.n_chunks,
              p.chunk_len,
              P,
              static_cast<int32_t>(p.D)};
    e = launch_sums<T>(p, a, device, st);
    if (e != cudaSuccess) return e;
    const int64_t blocks = (p.n_chunks + 32 * kWarps - 1) / (32 * kWarps);
    k1g_join<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        pairs, m, static_cast<T*>(out),
        reinterpret_cast<const float*>(scratch + p.o_part), p.n_chunks,
        p.chunk_len, static_cast<int32_t>(p.D));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (stages & kWrite) {
    const uint32_t* bits = p.n > 0 ? touched : nullptr;
    // a warp a word, but where a store covers whole rows: there a grid
    // the SMs hold at once, its warps taking words in turn
    const int64_t words = (p.H + 31) / 32;
    const int64_t want = (words + kWarps - 1) / kWarps;
    const int64_t most = int64_t{kZeroBlocksAnSm} * sm_count(device);
    const int64_t row_bytes = p.D * p.esize;
    T* o = static_cast<T*>(out);
    if (row_bytes % 16 == 0)
      k1g_zero<T, kRowVectors><<<static_cast<unsigned>(want), kThreads, 0,
                                 st>>>(o, bits, p.H, p.D);
    else if (16 % row_bytes == 0)
      k1g_zero<T, kRowsAVector><<<static_cast<unsigned>(
                                      want < most ? want : most),
                                  kThreads, 0, st>>>(o, bits, p.H, p.D);
    else
      k1g_zero<T, kElements><<<static_cast<unsigned>(want), kThreads, 0,
                               st>>>(o, bits, p.H, p.D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// layout[0] = scratch bytes; layout[1] = byte offset of the pair count
// (int32); [2]: the pairs as emitted ((row, flat index) int32 pairs);
// [3]: the pairs sorted.  0 or a cuda error code.
int repro_embedding_bag_grad_layout(int64_t n, int64_t H, int64_t D,
                                    int64_t dtype, int64_t* layout) {
  if (n < 0 || n >= (int64_t{1} << 31) || H <= 0 ||
      H >= (int64_t{1} << 31) || D <= 0 || D >= (int64_t{1} << 31) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n, H, D, dtype == 0 ? 4 : 2);
  const int b = sorted_buffer(p);
  layout[0] = p.bytes;
  layout[1] = p.o_meta;
  layout[2] = p.o_pairs[0];
  layout[3] = p.o_pairs[b];
  return 0;
}

// ids [n] int32 (bags of P slots; feature f = (i / P) % F), offsets [F]
// int64 or null (F = 1, offset 0), grad [n / P, D] and out [H, D] of
// `dtype` (0 = float32, 1 = bfloat16; both 16-byte aligned), scratch of
// the layout's size; 0 <= n < 2^31 (P = 0 only with n = 0: bags of no
// slot, an output of zeros), 0 < H < 2^31, D > 0; contiguous, on
// `device`.  Runs the stages set in `stages` (1 pairs, 2 sort, 4 sums, 8
// write; 15 all), each from what the earlier ones left in the scratch.
// lo >= 0: out holds rows [lo, lo + H) of the combined table (the row
// window; 0 the table's first H rows).
int repro_embedding_bag_grad(const void* ids, const void* offsets, int64_t n,
                             int64_t P, int64_t F, const void* grad,
                             void* out, int64_t H, int64_t lo, int64_t D,
                             int64_t dtype,
                             void* scratch, int64_t stages, int64_t device,
                             void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || P < 0 || (P == 0 && n > 0) ||
      F <= 0 || (P > 0 && n % P != 0) ||
      H <= 0 || H >= (int64_t{1} << 31) || lo < 0 || D <= 0 ||
      D >= (int64_t{1} << 31) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = make_plan(n, H, D, dtype == 0 ? 4 : 2);
  if (p.vec && (reinterpret_cast<uintptr_t>(grad) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(scratch);
  int32_t* m = reinterpret_cast<int32_t*>(s + p.o_meta);

  if (stages & kPairs) {
    if (p.tiles == 0) {
      e = cudaMemsetAsync(m, 0, 4, st);
    } else {
      const PairsArgs a{static_cast<const int32_t*>(ids),
                        static_cast<const int64_t*>(offsets), n,
                        static_cast<int32_t>(P), static_cast<int32_t>(F),
                        static_cast<int32_t>(H), lo};
      int32_t* tile = reinterpret_cast<int32_t*>(s + p.o_tile);
      int2* pairs = reinterpret_cast<int2*>(s + p.o_pairs[0]);
      const unsigned grid = static_cast<unsigned>(p.tiles);
      if (lo > 0)
        k1g_pairs_count<true><<<grid, kThreads, 0, st>>>(a, tile);
      else
        k1g_pairs_count<false><<<grid, kThreads, 0, st>>>(a, tile);
      k1g_scan_tiles<<<1, kScanThreads, 0, st>>>(tile, p.tiles, m);
      if (lo > 0)
        k1g_pairs_emit<true><<<grid, kThreads, 0, st>>>(a, tile, pairs);
      else
        k1g_pairs_emit<false><<<grid, kThreads, 0, st>>>(a, tile, pairs);
      e = cudaGetLastError();
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if ((stages & kSort) && p.tiles > 0) {
    int32_t* counts = reinterpret_cast<int32_t*>(s + p.o_counts);
    int32_t* sums = reinterpret_cast<int32_t*>(s + p.o_sums);
    const unsigned grid = static_cast<unsigned>(p.tiles);
    const unsigned scan_grid =
        static_cast<unsigned>((p.tiles + kScanTiles - 1) / kScanTiles);
    for (int pass = 0; pass < p.passes; ++pass) {
      const int src = pass % 2;
      const int shift = pass * p.width;
      const int2* in = reinterpret_cast<const int2*>(s + p.o_pairs[src]);
      k1g_sort_count<<<grid, kThreads, 0, st>>>(in, m, shift, p.width,
                                                counts);
      k1g_sort_scan_up<<<scan_grid, kThreads, 0, st>>>(counts, m, sums);
      k1g_sort_scan_mid<<<1, kDigits, 0, st>>>(sums, m);
      k1g_sort_scan_down<<<scan_grid, kThreads, 0, st>>>(counts, m, sums);
      k1g_sort_scatter<<<grid, kThreads, 0, st>>>(
          in, reinterpret_cast<int2*>(s + p.o_pairs[1 - src]), m, shift,
          p.width, counts);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  if (stages & (kSum | kWrite)) {
    const int dev = static_cast<int>(device);
    e = dtype == 0 ? reduce<float>(p, s, grad, out, static_cast<int32_t>(P),
                                   static_cast<int>(stages), dev, st)
                   : reduce<__nv_bfloat16>(p, s, grad, out,
                                           static_cast<int32_t>(P),
                                           static_cast<int>(stages), dev, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_embedding_bag_grad_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
