// K1 on Hopper: fused SparseLengthsSum (embedding bag).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/embedding_bag.py  hot_embedding_bag_pallas
// which pins the whole hot table in VMEM and gathers + pools one batch tile
// per grid step.  On an H100 a table does not fit in shared memory (227 KB a
// block), so it stays in HBM; its hot rows live in the 50 MB L2.
//
// Function: out[bag, :] = sum_{p : live} table[id + row_offsets[f] - lo, :]
//   with id = ids[bag, p], f = bag % F, and the slot live iff id >= 0 and
//   lo <= id + row_offsets[f] < hi;
//   table [H, D] f32 or bf16, ids [n_bags, P] int32 padded with -1 anywhere
//   in a bag, row_offsets [F] int64 (null: F = 1 and offset 0; a negative
//   offset pools its feature's bags to exactly zero), out [n_bags, D] in the
//   table's dtype or in f32 (the accumulator unrounded), summed in fp32.
//   The 2-D entry is F = 1 with no offsets; the 3-D entry is ids [B, F, P]
//   seen as B*F bags.  The row window [lo, hi) is how a rank of a row-sharded
//   table pools its own rows: the table is its shard of rows [lo, hi) of the
//   combined table, every other row counts as padding, and the f32 partial
//   is summed across ranks before its one rounding (repro_torch.dist.
//   sharded_embedding).  Without a window lo = 0 and hi = 2^63 - 1.
//
// What bounds it: bytes, reached only with enough rows in flight.  Each valid
// id gathers one D-row from HBM (or L2, or L1 for the hottest rows) for D
// adds, and a bag's rows are independent of each other.  A warp a bag with
// the row geometry a runtime value holds one row a lane group in flight,
// pays an id round trip per 32 slots and a loop trip per padding slot, and
// runs the rmc1 launch in 1.2 waves.  This design:
//   - Row geometry is compile-time: a lane group of L lanes covers a row, each
//     lane C vectors of V elements (16-byte loads; V = 1 is the scalar path
//     for unaligned tables or D not a multiple of the vector width).
//   - A team of S lane groups pools one bag (S = 4: a warp a bag at D = 32
//     f32 or D = 64 bf16); each group issues U = 4 independent row loads
//     before its first add (the SASS has them as a run of LDG.E.128 ahead of
//     the FADDs), so a team has 16 rows in flight, and the groups' partial
//     sums meet in one butterfly at the bag's end.  One group a bag (four
//     bags a warp, 8 rows each) was up to 7% slower at the rmc1 launch and
//     1.5x slower at the rm2 one (tools/k1_bench.py --sweep).
//   - Ids are read in chunks of K per lane (16-byte vectors where the bag's
//     ids are aligned) and compacted with a prefix popcount across the team
//     into shared memory, so padding (-1, anywhere in a bag) costs no row
//     load: a bag of n valid ids costs about ceil(n / (S * U)) round trips.
//     The batch loop runs to the warp's longest chunk with rows past a
//     team's count predicated off, so no team's last rows wait for a batch
//     of their own.
//   - The next chunk's ids (or the next bag's) and the next bag's offset are
//     loaded at the top of a chunk, so they arrive while its rows are loading.
//   - The grid is sized to what the card holds at once (occupancy x SMs);
//     teams take bags by a strided schedule, so a launch is one wave.
//   - Each bag is summed by one team in a fixed order (slot order within a
//     group, a fixed butterfly across groups) with no atomics: two launches
//     on the same inputs are bitwise equal, and the 3-D entry equals the 2-D
//     entry on the shifted ids.
//   - The window costs two 64-bit compares an id, in the compaction that
//     drops padding anyway: an id outside it is dropped there and loads
//     nothing; the kept ids are read at id + (offset - lo).  It is a
//     template flag: a launch without a window (and a table-dtype store)
//     runs an instance without the compares, which cost the rm2 bf16
//     launch 66% when they ran in every instance (tools/k1_bench.py --ab).
// Row addressing is 64-bit (id + offset - lo, times the row's vector count).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

// Launch settings, chosen on an H100 by tools/k1_bench.py --sweep (which
// times patched copies of this file).
constexpr int kWarps = 4;  // warps a block
constexpr int kTeam = 4;   // lane groups a bag, at rows of one vector a lane
constexpr int kRows = 4;   // rows a lane group has in flight
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

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

// V elements of T moved as one aligned load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Read-only load of one vector (LDG.E.128 for 16 bytes).
template <typename VecT>
__device__ __forceinline__ VecT load_vec(const VecT* p) {
  static_assert(sizeof(VecT) == 16 || sizeof(VecT) == 4 || sizeof(VecT) == 2,
                "vector of 16, 4 or 2 bytes");
  VecT v;
  if constexpr (sizeof(VecT) == 16) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    memcpy(&v, &q, sizeof(v));
  } else if constexpr (sizeof(VecT) == 4) {
    const int q = __ldg(reinterpret_cast<const int*>(p));
    memcpy(&v, &q, sizeof(v));
  } else {
    const unsigned short q = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&v, &q, sizeof(v));
  }
  return v;
}

// Ids a lane reads per chunk: four (one 16-byte vector) in wide groups, more
// in narrow ones so that a chunk holds at least 32 of a bag's ids.
template <int L>
__host__ __device__ constexpr int ids_per_lane() {
  return L >= 8 ? 4 : 32 / L;
}

// K consecutive ids of a bag from slot p (-1 past the bag's end or when the
// bag is not live).  vec: the bag's ids are 16-byte aligned (P % 4 == 0).
template <int K>
__device__ __forceinline__ void load_ids(int32_t (&dst)[K],
                                         const int32_t* __restrict__ bag_ids,
                                         int p, int P, bool live, bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      int4 q = make_int4(-1, -1, -1, -1);
      if (live && p + j < P)
        q = __ldg(reinterpret_cast<const int4*>(bag_ids + p + j));
      dst[j] = q.x;
      dst[j + 1] = q.y;
      dst[j + 2] = q.z;
      dst[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      dst[j] = (live && p + j < P) ? __ldg(bag_ids + p + j) : -1;
  }
}

// T: the table's type; O: the output's (T, or float for the f32 partial);
// kWindow: ids outside the row window [lo, hi) count as padding.
// L lanes a row, C vectors of V elements a lane; a team of S lane groups
// (L * S lanes) pools one bag, each group U of its rows at a time, so a team
// has S * U rows in flight.  kFit: L * C vectors cover each column block of
// the row exactly.  Grid: x = blocks of teams (at most what is resident),
// y = column blocks of L * C vectors (one unless a row is wider than 32 * 4
// vectors).  Bag indices are int: the host checks n_bags < 2^30.
template <typename T, typename O, bool kWindow, int V, int L, int C, int S,
          int U, bool kFit>
__global__ void __launch_bounds__(kThreads)
    k1_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                  const int64_t* __restrict__ row_offsets, O* __restrict__ out,
                  int n_bags, int P, int F, int n_vec, int vec_ids, int64_t lo,
                  int64_t hi) {
  using VecT = Vec<T, V>;
  using VecO = Vec<O, V>;
  constexpr int TL = L * S;              // lanes of a team
  constexpr int G = 32 / TL;             // bags a warp holds at once
  constexpr int K = ids_per_lane<TL>();  // ids a lane reads per chunk
  constexpr int CH = K * TL;             // ids a team reads per chunk
  constexpr int R = S * U;               // rows a team has in flight
  __shared__ __align__(16) int32_t s_ids[kWarps][G * CH];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = lane / TL;       // one bag
  const int t = lane - team * TL;   // lane within the team
  const int sub = t / L;            // lane group within the team
  const int l = t - sub * L;        // lane within the group: its columns
  int32_t* my_ids = s_ids[warp] + team * CH;

  const int n_teams = gridDim.x * kWarps * G;
  const int g0 = (blockIdx.x * kWarps + warp) * G;  // the warp's first team
  // every team of a warp runs the same number of chunks, so the shuffles
  // below are reached by the whole warp
  const int rounds =
      g0 < n_bags
          ? static_cast<int>((int64_t{n_bags} - g0 + n_teams - 1) / n_teams)
          : 0;
  const int n_chunks = (P + CH - 1) / CH;
  const int items = rounds * n_chunks;

  const int col0 = blockIdx.y * (L * C) + l;
  const VecT* rows = reinterpret_cast<const VecT*>(table) + col0;
  VecO* dst = reinterpret_cast<VecO*>(out) + col0;
  bool col_ok[C];
#pragma unroll
  for (int c = 0; c < C; ++c) col_ok[c] = kFit || col0 + c * L < n_vec;

  // the item (bag, chunk) whose ids are in flight
  int bag = g0 + team;
  int chunk = 0;
  bool live = bag < n_bags;
  int64_t off = (live && row_offsets) ? __ldg(row_offsets + bag % F) : 0;
  int32_t nxt[K];
  load_ids<K>(nxt, ids + static_cast<int64_t>(bag) * P, K * t, P, live,
              vec_ids);

  float acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[c][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    int32_t cur[K];
#pragma unroll
    for (int j = 0; j < K; ++j) cur[j] = nxt[j];
    const int cur_bag = bag;
    const bool cur_live = live;
    const int64_t cur_off = off;
    const bool bag_end = chunk == n_chunks - 1;

    // issue the next item's ids (and offset) now: they land while this
    // chunk's rows are in flight
    if (++chunk == n_chunks) {
      chunk = 0;
      bag += n_teams;
      live = bag < n_bags;
      off = (live && row_offsets) ? __ldg(row_offsets + bag % F) : 0;
    }
    if (i + 1 < items)
      load_ids<K>(nxt, ids + static_cast<int64_t>(bag) * P,
                  chunk * CH + K * t, P, live, vec_ids);

    // compact this chunk's live ids (valid, in the row window) into
    // my_ids[0, nv) in slot order
    unsigned m = 0;
    if (cur_off >= 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if constexpr (kWindow) {
          const int64_t g = static_cast<int64_t>(cur[j]) + cur_off;
          m |= (cur[j] >= 0 && g >= lo && g < hi ? 1u : 0u) << j;
        } else {
          m |= (cur[j] >= 0 ? 1u : 0u) << j;
        }
      }
    }
    const int64_t base = kWindow ? cur_off - lo : cur_off;  // row = id + base
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < TL; d <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, d, TL);
      if (t >= d) incl += v;
    }
    const int nv = __shfl_sync(kFullMask, incl, TL - 1, TL);
    int pos = incl - cnt;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (m >> j & 1u) my_ids[pos++] = cur[j];
    __syncwarp();

    // rows: each group loads U of the team's R rows (k + sub + S * u), all
    // independent, then adds them in that order.  The loop runs to the
    // warp's longest chunk, so no team's last rows wait for a batch of
    // their own; rows past a team's nv are predicated off.
    const int nv_warp = __reduce_max_sync(kFullMask, nv);
    for (int k = 0; k < nv_warp; k += R) {
      VecT r[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = k + sub + S * u;
        if (j < nv) {
          const VecT* src =
              rows + (static_cast<int64_t>(my_ids[j]) + base) * n_vec;
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (col_ok[c]) r[u][c] = load_vec(src + c * L);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + sub + S * u < nv) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (col_ok[c]) {
#pragma unroll
              for (int e = 0; e < V; ++e) acc[c][e] += to_f32(r[u][c].v[e]);
            }
        }
    }
    __syncwarp();  // my_ids is rewritten by the next chunk

    if (bag_end) {
      // the team's S partial sums, combined in a fixed butterfly order
#pragma unroll
      for (int o = L; o < TL; o <<= 1)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[c][e] += __shfl_xor_sync(kFullMask, acc[c][e], o);
      if (cur_live && sub == 0) {
        VecO* o = dst + static_cast<int64_t>(cur_bag) * n_vec;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (col_ok[c]) {
            VecO w;
#pragma unroll
            for (int e = 0; e < V; ++e) w.v[e] = from_f32<O>(acc[c][e]);
            o[c * L] = w;
          }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[c][e] = 0.f;
    }
  }
}

// The SMs of `device` (cached per device index below 64).
cudaError_t sm_count(int device, int* n) {
  static int cached[64] = {0};
  const bool cacheable = device >= 0 && device < 64;
  if (cacheable && cached[device] > 0) {
    *n = cached[device];
    return cudaSuccess;
  }
  const cudaError_t e =
      cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (*n <= 0) return cudaErrorInvalidDevice;
  if (cacheable) cached[device] = *n;
  return cudaSuccess;
}

struct Args {
  const void* table;
  const int32_t* ids;
  const int64_t* offsets;
  void* out;
  int64_t n_bags, P, F;
  int n_vec, device;
  bool vec_ids;
  cudaStream_t stream;
  int64_t lo, hi;  // the row window
};

// Launches the instance of one row geometry: a team of up to kTeam lane
// groups a bag (one group of 32 lanes at wider rows), a grid of at most the
// blocks the card holds at once.
template <typename T, typename O, bool kWindow, int V, int L, int C,
          bool kFit>
int launch_geometry(const Args& a) {
  constexpr int S = C == 1 ? (L * kTeam <= 32 ? kTeam : 32 / L) : 1;
  constexpr int U = kRows;
  auto kernel = k1_bag_kernel<T, O, kWindow, V, L, C, S, U, kFit>;
  static int per_sm = 0;  // blocks of this instance an SM holds at once
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm = n;
  }
  constexpr int64_t kTeamsPerBlock = kWarps * (32 / (L * S));
  const int col_blocks = (a.n_vec + L * C - 1) / (L * C);
  if (col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t e = sm_count(a.device, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t need = (a.n_bags + kTeamsPerBlock - 1) / kTeamsPerBlock;
  int64_t resident = static_cast<int64_t>(per_sm) * sms / col_blocks;
  if (resident < 1) resident = 1;
  const dim3 grid(static_cast<unsigned>(need < resident ? need : resident),
                  static_cast<unsigned>(col_blocks));
  kernel<<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.table), a.ids, a.offsets, static_cast<O*>(a.out),
      static_cast<int>(a.n_bags), static_cast<int>(a.P),
      static_cast<int>(a.F), a.n_vec, a.vec_ids ? 1 : 0, a.lo, a.hi);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors: a group as wide as the row where it has at most 32
// vectors, else 32 lanes of 2 or 4 vectors (column blocks past 128).
template <typename T, typename O, bool W, int V>
int launch_vector(const Args& a) {
  const int n = a.n_vec;
  switch (n) {
    case 1: return launch_geometry<T, O, W, V, 1, 1, true>(a);
    case 2: return launch_geometry<T, O, W, V, 2, 1, true>(a);
    case 4: return launch_geometry<T, O, W, V, 4, 1, true>(a);
    case 8: return launch_geometry<T, O, W, V, 8, 1, true>(a);
    case 16: return launch_geometry<T, O, W, V, 16, 1, true>(a);
    case 32: return launch_geometry<T, O, W, V, 32, 1, true>(a);
    case 64: return launch_geometry<T, O, W, V, 32, 2, true>(a);
    default: break;
  }
  if (n < 8) return launch_geometry<T, O, W, V, 8, 1, false>(a);
  if (n < 16) return launch_geometry<T, O, W, V, 16, 1, false>(a);
  if (n < 32) return launch_geometry<T, O, W, V, 32, 1, false>(a);
  if (n < 64) return launch_geometry<T, O, W, V, 32, 2, false>(a);
  if (n % 128 == 0) return launch_geometry<T, O, W, V, 32, 4, true>(a);
  return launch_geometry<T, O, W, V, 32, 4, false>(a);
}

// Scalar path (one element a lane): 32 lanes of 1, 2 or 4 elements.
template <typename T, typename O, bool W>
int launch_scalar(const Args& a) {
  const int n = a.n_vec;
  if (n == 32) return launch_geometry<T, O, W, 1, 32, 1, true>(a);
  if (n < 32) return launch_geometry<T, O, W, 1, 32, 1, false>(a);
  if (n == 64) return launch_geometry<T, O, W, 1, 32, 2, true>(a);
  if (n < 64) return launch_geometry<T, O, W, 1, 32, 2, false>(a);
  if (n % 128 == 0) return launch_geometry<T, O, W, 1, 32, 4, true>(a);
  return launch_geometry<T, O, W, 1, 32, 4, false>(a);
}

template <typename T, typename O, bool W>
int launch(Args a, int64_t D) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads
  const bool vec_ok =
      D % kVec == 0 && reinterpret_cast<uintptr_t>(a.table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.out) % (sizeof(O) * kVec) == 0;
  a.vec_ids = a.P % 4 == 0 && reinterpret_cast<uintptr_t>(a.ids) % 16 == 0;
  if (vec_ok) {
    a.n_vec = static_cast<int>(D / kVec);
    return launch_vector<T, O, W, kVec>(a);
  }
  a.n_vec = static_cast<int>(D);
  return launch_scalar<T, O, W>(a);
}

int dispatch(const void* table, const void* ids, const void* row_offsets,
             void* out, int64_t n_bags, int64_t P, int64_t F, int64_t D,
             int64_t dtype, int64_t out_dtype, int64_t lo, int64_t hi,
             int64_t device, void* stream) {
  if (n_bags <= 0 || P <= 0 || F <= 0 || D <= 0 || n_bags >= (1 << 30) ||
      P >= (1 << 30) || F >= (1 << 30) || D >= (int64_t{1} << 31) ||
      lo < 0 || hi < lo)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{table,
         static_cast<const int32_t*>(ids),
         static_cast<const int64_t*>(row_offsets),
         out,
         n_bags,
         P,
         F,
         0,
         static_cast<int>(device),
         false,
         static_cast<cudaStream_t>(stream),
         lo,
         hi};
  using bf16 = __nv_bfloat16;
  const bool window = lo != 0 || hi != INT64_MAX;
  if (dtype == 0 && out_dtype == 0)
    return window ? launch<float, float, true>(a, D)
                  : launch<float, float, false>(a, D);
  if (dtype == 1 && out_dtype == 1)
    return window ? launch<bf16, bf16, true>(a, D)
                  : launch<bf16, bf16, false>(a, D);
  // the f32 store of a bf16 table: the sharded lookup's partial
  if (dtype == 1 && out_dtype == 0) return launch<bf16, float, true>(a, D);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype (the table's) and out_dtype: 0 = float32, 1 = bfloat16; out_dtype
// is dtype, or float32 for a bf16 table.  ids [n_bags, P] int32;
// row_offsets [F] int64 or null (then F must be 1).  The table holds rows
// [lo, hi) of the combined table (lo = 0, hi = 2^63 - 1: the whole table).
// Requires 0 < n_bags, P, F < 2^30, 0 < D < 2^31, 0 <= lo <= hi,
// contiguous row-major tensors on `device`.
int repro_embedding_bag(const void* table, const void* ids,
                        const void* row_offsets, void* out, int64_t n_bags,
                        int64_t P, int64_t F, int64_t D, int64_t dtype,
                        int64_t out_dtype, int64_t lo, int64_t hi,
                        int64_t device, void* stream) {
  return dispatch(table, ids, row_offsets, out, n_bags, P, F, D, dtype,
                  out_dtype, lo, hi, device, stream);
}

const char* repro_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
