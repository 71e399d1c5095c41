// K3 on Hopper: split-KV flash decode (one query token against a KV cache).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_decode.py  flash_decode_partials
//   (body _decode_kernel; flash_decode_pallas adds the final divide)
// whose grid walks (batch x kv head, KV chunk) and emits per-chunk softmax
// partials that lse_combine merges outside the kernel.
//
// Function: for each batch b, kv head j and query head h = j * G + g,
//   s[r] = q[b, h] . k[b, r, j] / sqrt(hd)    for live rows r,
//   live: kv_offset + r < kv_len  (global position of local row r)
//   m = max_r s[r],  l = sum_r exp(s[r] - m),  o = sum_r exp(s[r] - m) v[b, r, j]
// in f32, q/k/v f32 or bf16 with k/v [B, S, KVH, hd] and q [B, 1, H, hd].
// With no live row the partial is exactly m = -1e30, l = 0, o = 0.
// Output either the merged partials (m, l [B, KVH, G, 1], o [B, KVH, G, hd],
// f32) or the attention o / max(l, 1e-30) as [B, 1, H, hd] in q's dtype.
//
// What bounds it: bytes.  Each live K and V row is read once (2 x hd x
// dtype bytes) for 4 x G x hd flops, about 3 flops a byte for bf16 and
// G = 3, two orders below the card's balance point.  The design:
//   - block = (batch x kv head, split of the live rows); the G query rows
//     of one kv head are one register tile, so each K/V row is read once
//     for all of them;
//   - rows past kv_len are never read: the launcher splits only the live
//     range [0, kv_len - kv_offset), so a short cache in a long buffer
//     costs what it holds;
//   - each row is L = hd / (16 / sizeof(T)) lanes of 16-byte loads; a warp
//     holds 32 / L rows at once and unrolls 4 rows deep, so a 4-warp block
//     keeps 4 x 32 x 16 B x 2 in flight;
//   - online softmax in f32 registers per lane group, merged across lane
//     groups by shuffles, across warps in shared memory, across splits by
//     a second small kernel (decode_combine_kernel) that also applies the
//     final divide when the attention itself is asked for.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// One block: kv head `bh` (= b * KVH + j), rows [split * split_len,
// min(n_live, (split + 1) * split_len)).  Writes the split's partial
// (pm, pl [BH, n_splits, G]; po [BH, n_splits, G, hd]).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ pm,
                        float* __restrict__ pl, float* __restrict__ po,
                        int64_t S, int KVH, int hd, int64_t n_live,
                        int64_t split_len, int n_splits, float scale) {
  constexpr int V = 16 / sizeof(T);
  using VecT = Vec<T, V>;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_o[kWarps * G * kMaxHd];

  const int L = hd / V;  // lanes per row, divides 32
  const int R = 32 / L;  // rows per warp pass
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / L;
  const int col = lane - slot * L;
  const int64_t bh = blockIdx.x / n_splits;
  const int split = static_cast<int>(blockIdx.x - bh * n_splits);
  const int64_t b = bh / KVH;
  const int64_t j = bh - b * KVH;
  const int64_t r0 = static_cast<int64_t>(split) * split_len;
  const int64_t r1 = r0 + split_len < n_live ? r0 + split_len : n_live;

  // q rows h = j * G + g of batch b are contiguous: [G, hd]
  float qf[G][V];
  const VecT* qv = reinterpret_cast<const VecT*>(q + bh * G * hd);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const VecT t = qv[g * L + col];
#pragma unroll
    for (int i = 0; i < V; ++i) qf[g][i] = to_f32(t.v[i]) * scale;
  }
  float m[G], l[G], o[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) o[g][i] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(KVH) * hd;
  const T* kb = k + (b * S * KVH + j) * hd + col * V;
  const T* vb = v + (b * S * KVH + j) * hd + col * V;
  const int slots = kWarps * R;
  const int64_t my_off = warp * R + slot;

  // the loop bound is uniform across the block, so every lane reaches the
  // shuffles; rows past r1 load nothing and weigh 0
  for (int64_t it = r0; it < r1; it += static_cast<int64_t>(slots) * kUnroll) {
    VecT kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = it + u * slots + my_off;
      ok[u] = r < r1;
      if (ok[u]) {
        kr[u] = *reinterpret_cast<const VecT*>(kb + r * row_stride);
        vr[u] = *reinterpret_cast<const VecT*>(vb + r * row_stride);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          kr[u].v[i] = from_f32<T>(0.f);
          vr[u].v[i] = from_f32<T>(0.f);
        }
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) acc += qf[g][i] * to_f32(kr[u].v[i]);
        s[u][g] = acc;
      }
    }
    // dot products: sum over the L lanes of each row (aligned groups)
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float alpha = __expf(m[g] - mx);
      float p[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? __expf(s[u][g] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float acc = o[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += p[u] * to_f32(vr[u].v[i]);
        o[g][i] = acc;
      }
      m[g] = mx;
    }
  }

  // merge the R lane groups of the warp: lanes l, l + L, l + 2L, ... hold
  // partials of the same columns.  Empty partials stay exactly empty.
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = __expf(m[g] - mx);
      const float c = __expf(mo - mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float oo = __shfl_xor_sync(kFull, o[g][i], off);
        o[g][i] = o[g][i] * a + oo * c;
      }
      m[g] = mx;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        sm_o[(warp * G + g) * hd + col * V + i] = o[g][i];
      if (col == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write the split's partial
  const int64_t part = bh * n_splits + split;
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd;
    const int c = idx - g * hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = __expf(sm_m[w][g] - mx);
      acc += sm_o[(w * G + g) * hd + c] * a;
      lsum += sm_l[w][g] * a;
    }
    po[(part * G + g) * hd + c] = acc;
    if (c == 0) {
      pm[part * G + g] = mx;
      pl[part * G + g] = lsum;
    }
  }
}

// One block per kv head: merge its n_splits partials (n_splits may be 0:
// the empty partial).  With `out` set, writes o / max(l, 1e-30) in T at
// out[b, 0, j * G + g, :]; otherwise the merged m, l, o in f32.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ pm,
                          const float* __restrict__ pl,
                          const float* __restrict__ po, int n_splits, int hd,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          float* __restrict__ o_out, T* __restrict__ out) {
  const int64_t bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd;
    const int c = idx - g * hd;
    float mx = kNegInf;
    for (int s = 0; s < n_splits; ++s)
      mx = fmaxf(mx, pm[(bh * n_splits + s) * G + g]);
    float acc = 0.f, lsum = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const int64_t p = (bh * n_splits + s) * G + g;
      const float a = expf(pm[p] - mx);
      acc += po[p * hd + c] * a;
      lsum += pl[p] * a;
    }
    const int64_t dst = (bh * G + g) * hd + c;
    if (out != nullptr) {
      out[dst] = from_f32<T>(acc / fmaxf(lsum, 1e-30f));
    } else {
      o_out[dst] = acc;
      if (c == 0) {
        m_out[bh * G + g] = mx;
        l_out[bh * G + g] = lsum;
      }
    }
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, float* pm, float* pl,
           float* po, float* m_out, float* l_out, float* o_out, void* out,
           int64_t BH, int64_t S, int KVH, int hd, int64_t n_live,
           int64_t split_len, int n_splits, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  if (n_splits > 0) {
    decode_split_kernel<T, G><<<static_cast<unsigned>(BH * n_splits),
                                kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pm, pl, po, S, KVH, hd, n_live, split_len,
        n_splits, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_combine_kernel<T, G><<<static_cast<unsigned>(BH), kThreads, 0,
                                stream>>>(pm, pl, po, n_splits, hd, m_out,
                                          l_out, o_out, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int G, const void* q, const void* k, const void* v,
                   float* pm, float* pl, float* po, float* m_out,
                   float* l_out, float* o_out, void* out, int64_t BH,
                   int64_t S, int KVH, int hd, int64_t n_live,
                   int64_t split_len, int n_splits, cudaStream_t s) {
#define REPRO_DECODE_CASE(NG)                                               \
  case NG:                                                                  \
    return launch<T, NG>(q, k, v, pm, pl, po, m_out, l_out, o_out, out, BH, \
                         S, KVH, hd, n_live, split_len, n_splits, s);
  switch (G) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(3)
    REPRO_DECODE_CASE(4)
    REPRO_DECODE_CASE(5)
    REPRO_DECODE_CASE(6)
    REPRO_DECODE_CASE(7)
    REPRO_DECODE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

extern "C" {

// q [B, 1, KVH * G, hd], k/v [B, S, KVH, hd] contiguous, 16-byte aligned,
// dtype 0 = float32, 1 = bfloat16.  hd * sizeof(T) / 16 divides 32 and
// hd <= 256; 1 <= G <= 8.  Scratch pm, pl [B * KVH * n_splits * G] and
// po [... * hd] f32.  `out` (q's dtype, [B, 1, H, hd]) selects the
// attention; when null, m_out/l_out [B, KVH, G, 1] and o_out
// [B, KVH, G, hd] receive the merged partials.
int repro_flash_decode(const void* q, const void* k, const void* v, void* pm,
                       void* pl, void* po, void* m_out, void* l_out,
                       void* o_out, void* out, int64_t B, int64_t S,
                       int64_t KVH, int64_t G, int64_t hd, int64_t n_live,
                       int64_t split_len, int64_t n_splits, int64_t dtype,
                       int64_t device, void* stream) {
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f_pm = static_cast<float*>(pm);
  float* f_pl = static_cast<float*>(pl);
  float* f_po = static_cast<float*>(po);
  float* f_m = static_cast<float*>(m_out);
  float* f_l = static_cast<float*>(l_out);
  float* f_o = static_cast<float*>(o_out);
  const int64_t BH = B * KVH;
  if (dtype == 0)
    return dispatch_group<float>(static_cast<int>(G), q, k, v, f_pm, f_pl,
                                 f_po, f_m, f_l, f_o, out, BH, S,
                                 static_cast<int>(KVH), static_cast<int>(hd),
                                 n_live, split_len,
                                 static_cast<int>(n_splits), s);
  if (dtype == 1)
    return dispatch_group<__nv_bfloat16>(
        static_cast<int>(G), q, k, v, f_pm, f_pl, f_po, f_m, f_l, f_o, out, BH,
        S, static_cast<int>(KVH), static_cast<int>(hd), n_live, split_len,
        static_cast<int>(n_splits), s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
