// K1 on Hopper: fused hot-embedding SparseLengthsSum (embedding bag).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/embedding_bag.py  hot_embedding_bag_pallas
// which pins the whole hot table in VMEM and gathers + pools one batch tile
// per grid step.  On an H100 a table does not fit in shared memory (227 KB a
// block), so it stays in HBM; its hot rows live in the 50 MB L2.
//
// Function: out[b, :] = sum_{p : ids[b, p] >= 0} table[ids[b, p], :]
//   table [H, D] f32 or bf16, ids [n_bags, P] int32 padded with -1,
//   out [n_bags, D] in the table's dtype, accumulated in fp32.
//
// What bounds it: bytes.  Each valid id gathers one D-row (D x dtype bytes)
// from HBM or L2 and does D adds, far below the card's FLOP/byte balance.
// The design moves each gathered row once and nothing else:
//   - one warp per bag, the bag's P ids read coalesced (one id per lane) and
//     handed out with __shfl_sync;
//   - lanes split into G = 32 / L groups of L lanes, each lane a 16-byte
//     vector of the row, so a warp has G independent rows in flight;
//   - masked ids (< 0) issue no load;
//   - fp32 accumulators in registers, one butterfly across the G groups,
//     one store per bag.
// Row addressing is 64-bit (row * D passes 2^31 for tables past 33.5 M rows
// at D = 64); ids stay int32 and the Python wrapper rejects H >= 2^31.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
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

// L lanes cover one row chunk of L vectors; G = 32 / L row slots per warp.
template <typename T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    embedding_bag_kernel(const T* __restrict__ table,
                         const int32_t* __restrict__ ids, T* __restrict__ out,
                         int64_t n_bags, int64_t P, int64_t n_vec, int L) {
  using VecT = Vec<T, V>;
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // uniform across the warp

  const int G = 32 / L;
  const int g = lane / L;      // row slot of this lane
  const int l = lane - g * L;  // vector column within the chunk
  const int32_t* bag_ids = ids + bag * P;
  const VecT* rows = reinterpret_cast<const VecT*>(table);
  VecT* dst = reinterpret_cast<VecT*>(out) + bag * n_vec;

  for (int64_t c0 = 0; c0 < n_vec; c0 += L) {
    const int64_t c = c0 + l;
    const bool col_ok = c < n_vec;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;

    for (int64_t p0 = 0; p0 < P; p0 += 32) {
      // lanes past the bag's end hold -1, so their slots load nothing
      const int32_t my_id = (p0 + lane < P) ? __ldg(bag_ids + p0 + lane) : -1;
      const int n = static_cast<int>(P - p0 < 32 ? P - p0 : 32);
      // j is a multiple of G and G divides 32, so j + g <= 31
      for (int j = 0; j < n; j += G) {
        const int32_t id = __shfl_sync(kFullMask, my_id, j + g);
        if (id >= 0 && col_ok) {
          const VecT r = rows[static_cast<int64_t>(id) * n_vec + c];
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += to_f32(r.v[k]);
        }
      }
    }
    // lanes l, l + L, l + 2L, ... hold partial sums of the same column
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] += __shfl_xor_sync(kFullMask, acc[k], off);
    }
    if (g == 0 && col_ok) {
      VecT r;
#pragma unroll
      for (int k = 0; k < V; ++k) r.v[k] = from_f32<T>(acc[k]);
      dst[c] = r;
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, void* out, int64_t n_bags,
           int64_t P, int64_t D, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads
  const bool vec_ok = D % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t n_vec = vec_ok ? D / kVec : D;
  // a row of <= 32 vectors whose count divides 32 gets 32 / n_vec row slots;
  // otherwise one slot and the lanes stride over the row
  const int L = (n_vec <= 32 && 32 % n_vec == 0) ? static_cast<int>(n_vec) : 32;
  const dim3 grid(
      static_cast<unsigned>((n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  const T* t = static_cast<const T*>(table);
  const int32_t* i = static_cast<const int32_t*>(ids);
  T* o = static_cast<T*>(out);
  if (vec_ok)
    embedding_bag_kernel<T, kVec><<<grid, block, 0, stream>>>(t, i, o, n_bags,
                                                              P, n_vec, L);
  else
    embedding_bag_kernel<T, 1><<<grid, block, 0, stream>>>(t, i, o, n_bags, P,
                                                           n_vec, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Requires n_bags > 0 and D > 0,
// contiguous row-major tensors on `device`.
int repro_embedding_bag(const void* table, const void* ids, void* out,
                        int64_t n_bags, int64_t P, int64_t D, int64_t dtype,
                        int64_t device, void* stream) {
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table, ids, out, n_bags, P, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(table, ids, out, n_bags, P, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
