// K1's backward on Hopper: the dense table gradient of the embedding bag.
//
// Replaces the autodiff of the reference's single-shard embedding bag,
//   src/repro/models/embedding.py:138  embedding_bag_local (jnp.take and a
//   masked sum), which jax.grad transposes into a scatter-add of each bag's
//   gradient row into the rows the bag read.
// The TPU kernel hot_embedding_bag_pallas has no backward of its own.
//
// Function: out[r, :] = sum over valid (bag, slot) pairs reading row r of
//   grad[bag, :], summed in fp32 (compensated) and written in the table's
//   dtype.  A pair
//   that reads row r twice in one bag counts twice; padding and unrouted
//   features read no row.
//
// The wrapper (ops.embedding_bag_features_grad) prepares, with torch ops:
//   keys [n] int32, sorted ascending by a stable sort: the row each
//     (bag, slot) pair reads, or H for a pair that reads none (padding, an
//     unrouted feature, an id past the table), so those sort last;
//   perm [n] int64: each sorted pair's flat index bag * P + slot;
//   out [H, D] zeroed by one zero_ (untouched rows stay zero: the kernel
//     writes only the rows some pair reads);
//   part [2, n_chunks, D] fp32 scratch.
//
// What bounds it: bytes.  Each valid pair reads one D-row of the pooled
// gradient, and the dense output is written whole (by the zero_ and the
// touched rows).  The click log's ids are power-law, so one row can hold a
// run of ~10^5 pairs: a run cannot be one warp's sequential work.  Design:
//   - Pass 1: the sorted pairs are cut into chunks of kChunk; a warp takes a
//     chunk and walks it in order, 32 keys and permutation entries at a time
//     (coalesced), then kRows gradient rows in flight at once (independent
//     loads) before adding them in order.  Lanes hold the columns (lane l:
//     columns l, l + 32, ...; C of them, a compile-time count).  A run that
//     starts and ends in the chunk is written to out once.  The piece of a
//     run that began before the chunk goes to part[0][chunk]; the piece of a
//     run that starts in the chunk and goes on past it to part[1][chunk].
//   - Pass 2: the warp of a chunk that owns such a crossing run (it starts
//     there) adds the part[0] pieces of the chunks after it, in order, and
//     writes the row.
// Every row is summed in one fixed order (sorted order within a chunk, then
// the chunks' pieces in chunk order) with no atomics: two launches on the
// same inputs are bitwise equal.  The sums are compensated (Neumaier): a
// hot row adds thousands of gradient rows that largely cancel, and a plain
// float32 sum of them drifts by many ulps of the result.  Row and output
// offsets are 64-bit (rm2's table has 8.3e9 elements).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;       // warps a block, one chunk each
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;    // sorted pairs a warp
constexpr int kRows = 8;        // gradient rows a warp has in flight
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

// s + x into the sum s and its running compensation e (Neumaier): the
// rounding error of each add is kept in e; the sum is s + e.
__device__ __forceinline__ void add_comp(float& s, float& e, float x) {
  const float t = s + x;
  e += fabsf(s) >= fabsf(x) ? (s - t) + x : (x - t) + s;
  s = t;
}

// Where the sum of one run (or run piece) in chunk `chunk` goes: out[row]
// for a whole run, part[0] for the piece of a run that began before the
// chunk, part[1] for a run that starts here and goes on past the chunk.
template <typename T, int C>
__device__ __forceinline__ void flush(const float (&acc)[C],
                                      const float (&err)[C], int32_t row,
                                      bool head, bool crosses, int64_t chunk,
                                      int64_t n_chunks, T* __restrict__ out,
                                      float* __restrict__ part, int col0,
                                      int D) {
  if (head || crosses) {
    float* dst = part + ((head ? 0 : n_chunks) + chunk) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col0 + 32 * c < D) dst[col0 + 32 * c] = acc[c] + err[c];
  } else {
    T* dst = out + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col0 + 32 * c < D)
        dst[col0 + 32 * c] = from_f32<T>(acc[c] + err[c]);
  }
}

// Pass 1.  Grid: x = blocks of kWarps chunks, y = column blocks of 32 * C.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    k1_grad_runs(const int32_t* __restrict__ keys,
                 const int64_t* __restrict__ perm, const T* __restrict__ grad,
                 T* __restrict__ out, float* __restrict__ part, int64_t n,
                 int64_t P, int32_t H, int D, int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const int col0 = blockIdx.y * (32 * C) + lane;
  const int64_t s = chunk * kChunk;
  const int64_t e = s + kChunk < n ? s + kChunk : n;

  // the run in progress: its row, whether it began before the chunk, and
  // whether it has a pair in the chunk yet
  int32_t cur = s > 0 ? __ldg(keys + s - 1) : -1;
  bool head = true;
  bool has = false;
  float acc[C], err[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = err[c] = 0.f;

  for (int64_t base = s; base < e; base += 32) {
    const int64_t i = base + lane;
    const int32_t k = i < e ? __ldg(keys + i) : H;
    const int64_t bag = i < e && k < H ? __ldg(perm + i) / P : 0;
    const int cnt = static_cast<int>(e - base < 32 ? e - base : 32);
    for (int j = 0; j < cnt; j += kRows) {
      int32_t kk[kRows];
      float r[kRows][C];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        kk[u] = __shfl_sync(kFullMask, k, (j + u) & 31);
        const int64_t b = __shfl_sync(kFullMask, bag, (j + u) & 31);
        const bool live = j + u < cnt && kk[u] >= 0 && kk[u] < H;
        const T* src = grad + b * D;
#pragma unroll
        for (int c = 0; c < C; ++c)
          r[u][c] = live && col0 + 32 * c < D ? to_f32(src[col0 + 32 * c])
                                              : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (j + u >= cnt) break;
        if (kk[u] != cur) {
          if (has && cur >= 0 && cur < H)
            flush<T, C>(acc, err, cur, head, false, chunk, n_chunks, out,
                        part, col0, D);
          cur = kk[u];
          head = false;
          has = false;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = err[c] = 0.f;
        }
        has = true;
#pragma unroll
        for (int c = 0; c < C; ++c) add_comp(acc[c], err[c], r[u][c]);
      }
    }
  }
  if (has && cur >= 0 && cur < H) {
    const bool crosses = e < n && __ldg(keys + e) == cur;
    flush<T, C>(acc, err, cur, head, crosses, chunk, n_chunks, out, part,
                col0, D);
  }
}

// Pass 2: the owner of a run that crosses its chunk's end adds the pieces
// of the chunks it reaches into, in chunk order, and writes the row.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    k1_grad_join(const int32_t* __restrict__ keys, T* __restrict__ out,
                 const float* __restrict__ part, int64_t n, int32_t H, int D,
                 int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;
  const int col0 = blockIdx.y * (32 * C) + lane;
  const int64_t s = chunk * kChunk;
  const int64_t e = s + kChunk < n ? s + kChunk : n;
  const int32_t row = __ldg(keys + e - 1);
  if (row < 0 || row >= H || e >= n || __ldg(keys + e) != row) return;
  if (s > 0 && __ldg(keys + s - 1) == row) return;  // began before: not ours
  float acc[C], err[C];
  const float* own = part + (n_chunks + chunk) * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = col0 + 32 * c < D ? own[col0 + 32 * c] : 0.f;
    err[c] = 0.f;
  }
  for (int64_t c2 = chunk + 1;
       c2 < n_chunks && __ldg(keys + c2 * kChunk) == row; ++c2) {
    const float* piece = part + c2 * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col0 + 32 * c < D) add_comp(acc[c], err[c], piece[col0 + 32 * c]);
  }
  T* dst = out + static_cast<int64_t>(row) * D;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (col0 + 32 * c < D) dst[col0 + 32 * c] = from_f32<T>(acc[c] + err[c]);
}

struct Args {
  const int32_t* keys;
  const int64_t* perm;
  const void* grad;
  void* out;
  float* part;
  int64_t n, P, n_chunks;
  int32_t H;
  int D;
  cudaStream_t stream;
};

template <typename T, int C>
int launch_cols(const Args& a) {
  const int col_blocks = (a.D + 32 * C - 1) / (32 * C);
  const int64_t blocks = (a.n_chunks + kWarps - 1) / kWarps;
  if (col_blocks > 65535 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(col_blocks));
  k1_grad_runs<T, C><<<grid, kThreads, 0, a.stream>>>(
      a.keys, a.perm, static_cast<const T*>(a.grad), static_cast<T*>(a.out),
      a.part, a.n, a.P, a.H, a.D, a.n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k1_grad_join<T, C><<<grid, kThreads, 0, a.stream>>>(
      a.keys, static_cast<T*>(a.out), a.part, a.n, a.H, a.D, a.n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a) {
  if (a.D <= 32) return launch_cols<T, 1>(a);
  if (a.D <= 64) return launch_cols<T, 2>(a);
  if (a.D <= 128) return launch_cols<T, 4>(a);
  return launch_cols<T, 8>(a);  // column blocks of 256 past that
}

}  // namespace

extern "C" {

// keys [n] int32 sorted (H for pairs that read no row), perm [n] int64,
// grad [n_bags, D] and out [H, D] of `dtype` (0 = float32, 1 = bfloat16),
// out zeroed, part [2, ceil(n / chunk), D] float32; n > 0, P > 0,
// 0 < H < 2^31, 0 < D < 2^31; contiguous tensors on `device`.
int repro_embedding_bag_grad(const void* keys, const void* perm,
                             const void* grad, void* out, void* part,
                             int64_t n, int64_t P, int64_t H, int64_t D,
                             int64_t dtype, int64_t device, void* stream) {
  if (n <= 0 || P <= 0 || H <= 0 || H >= (int64_t{1} << 31) || D <= 0 ||
      D >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{static_cast<const int32_t*>(keys),
         static_cast<const int64_t*>(perm),
         grad,
         out,
         static_cast<float*>(part),
         n,
         P,
         (n + kChunk - 1) / kChunk,
         static_cast<int32_t>(H),
         static_cast<int>(D),
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Sorted pairs a warp takes (the wrapper sizes `part` with it).
int64_t repro_embedding_bag_grad_chunk() { return kChunk; }

const char* repro_embedding_bag_grad_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
