// K2 on Hopper: blocked causal GQA flash attention (prefill shapes).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py  flash_attention_pallas
//   (body _fa_kernel)
// whose grid (B*H, Tq/bq, Tk/bk) carries the running max, sum and output
// accumulator across the sequential KV axis in VMEM scratch.  Here blocks
// run in parallel in no order, so one block owns a query tile and loops
// over the KV tiles itself.
//
// Function: out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(hd))
//   . v[b, j, h / G], j over all keys, or with `causal` over
//   j <= q_offset + i; q [B, Tq, H, hd], k/v [B, Tk, KVH, hd], G = H / KVH,
//   output in q's dtype.  f32 running max, sum and accumulator; the
//   denominator is clamped at 1e-30.
//
// What bounds it: operations.  At prefill lengths a query tile reads each
// K/V tile once for 4 x BQ x hd flops a key row, far above the card's
// balance point, so the tensor cores set the pace.  Two variants:
//   - fa_mma_kernel (bf16, hd 64 or 128): 4 warps x 16 query rows; Q is
//     held in registers as mma.sync m16n8k16 A fragments, each 64-row K/V
//     tile is staged in shared memory with cp.async (rows padded by 16
//     bytes, so the fragment loads are free of bank conflicts), S = Q K^T
//     and O += P V run on the tensor cores with f32 accumulators, and P
//     moves from the S accumulators to A fragments in registers (V's
//     fragments come from ldmatrix.trans).  Tiles above the diagonal are
//     skipped whole; the heaviest (last) query tiles are scheduled first.
//   - fa_simt_kernel (f32, or bf16 at other head sizes): CUDA-core FMAs in
//     f32; a lane scores one key row of a 32-row tile for 8 query rows, and
//     P V accumulates over the lanes' columns.  It exists for the f32
//     parity path, not for speed.
// The single-stage load (no double buffer) and mma.sync instead of wgmma
// and TMA are the first version's; see PERF.md for how far that is from
// the bound.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;  // 4 warps x 16 query rows
constexpr int kMmaBK = 64;
constexpr int kMmaThreads = 128;
constexpr int kPad = 8;  // bf16 elements added to each shared row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    fa_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int Tq, int Tk, int H,
                  int KVH, int causal, int q_offset, int n_qtiles,
                  float scale_log2) {
  constexpr int LDS = HD + kPad;
  constexpr int KS = HD / 16;  // k-steps of S = Q K^T
  constexpr int NO = HD / 8;   // n-tiles of O
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sK[kMmaBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[kMmaBK * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int BH = gridDim.x / n_qtiles;
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);

  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * Tq * H + h) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Tk * KVH + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Tk * KVH + kvh) * HD;
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * Tq * H + h) * HD;

  const int row_a = qtile * kMmaBQ + warp * 16 + gid;  // this thread's rows
  const int row_b = row_a + 8;
  const int pos_a = q_offset + row_a;
  const int pos_b = q_offset + row_b;

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = row_a < Tq ? *reinterpret_cast<const uint32_t*>(qb + row_a * q_stride + c) : 0u;
    qa[ks][1] = row_b < Tq ? *reinterpret_cast<const uint32_t*>(qb + row_b * q_stride + c) : 0u;
    qa[ks][2] = row_a < Tq ? *reinterpret_cast<const uint32_t*>(qb + row_a * q_stride + c + 8) : 0u;
    qa[ks][3] = row_b < Tq ? *reinterpret_cast<const uint32_t*>(qb + row_b * q_stride + c + 8) : 0u;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // keys this tile can see: all, or with causal up to its last query
  int kv_end = Tk;
  if (causal) {
    const int64_t last = static_cast<int64_t>(q_offset) + (qtile + 1) * kMmaBQ;
    kv_end = last < 0 ? 0 : (last < Tk ? static_cast<int>(last) : Tk);
  }
  const int n_kt = (kv_end + kMmaBK - 1) / kMmaBK;
  // the lowest query position of the tile: tiles wholly below it need no mask
  const int first_pos = q_offset + qtile * kMmaBQ;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < kMmaBK * CH; c += kMmaThreads) {
      const int r = c / CH;
      const int cc = (c - r * CH) * 8;
      __nv_bfloat16* dk = sK + r * LDS + cc;
      __nv_bfloat16* dv = sV + r * LDS + cc;
      if (k0 + r < Tk) {
        cp_async_16(dk, kb + (k0 + r) * kv_stride + cc);
        cp_async_16(dv, vb + (k0 + r) * kv_stride + cc);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = sK + (n * 8 + gid) * LDS + ks * 16 + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[n], qa[ks], b0, b1);
      }
    }

    // scale into the exp2 domain; mask the diagonal and the ragged edge
    const bool need_mask = k0 + kMmaBK > Tk || (causal && k0 + kMmaBK - 1 > first_pos);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + n * 8 + tig * 2 + (e & 1);
          const int pos = e < 2 ? pos_a : pos_b;
          if (key >= Tk || (causal && key > pos)) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
    }
    // a row with no live key yet keeps m = -inf; subtract 0 instead
    const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
    const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
    const float alpha_a = exp2f(m_a - base_a);
    const float alpha_b = exp2f(m_b - base_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - base_a);
      s[n][1] = exp2f(s[n][1] - base_a);
      s[n][2] = exp2f(s[n][2] - base_b);
      s[n][3] = exp2f(s[n][3] - base_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;  // this thread's columns; summed at the end
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mi = lane >> 3;
      const int vrow = kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + vrow * LDS + (n + (mi >> 1)) * 8);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (row_a < Tq)
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + c) =
          pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < Tq)
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + c) =
          pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32 (and generic) CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kSimtBQ = 32;  // 4 warps x 8 query rows
constexpr int kSimtRows = 8;
constexpr int kSimtBK = 32;  // one key row per lane
constexpr int kSimtThreads = 128;
constexpr int kMaxSimtHd = 256;

// shared floats: Q [BQ][hd], K [BK][hd + 1], V [BK][hd], P [4][8][32]
__host__ __device__ constexpr size_t simt_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kSimtBQ) * hd +
                          static_cast<size_t>(kSimtBK) * (hd + 1) +
                          static_cast<size_t>(kSimtBK) * hd +
                          4 * kSimtRows * 32);
}

// NC = ceil(hd / 32) output columns per lane
template <typename T, int NC>
__global__ void __launch_bounds__(kSimtThreads)
    fa_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int Tq,
                   int Tk, int H, int KVH, int hd, int causal, int q_offset,
                   int n_qtiles, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kSimtBQ * hd;
  float* sV = sK + kSimtBK * (hd + 1);
  float* sP = sV + kSimtBK * hd;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int BH = gridDim.x / n_qtiles;
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  const int64_t kv_stride = static_cast<int64_t>(KVH) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * Tq * H + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * Tk * KVH + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * Tk * KVH + kvh) * hd;
  T* ob = out + (static_cast<int64_t>(b) * Tq * H + h) * hd;
  const int q0 = qtile * kSimtBQ;

  for (int i = tid; i < kSimtBQ * hd; i += kSimtThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    sQ[i] = q0 + r < Tq ? to_f32(qb[(q0 + r) * q_stride + c]) : 0.f;
  }

  float o[kSimtRows][NC];
  float m[kSimtRows], l[kSimtRows];
#pragma unroll
  for (int j = 0; j < kSimtRows; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) o[j][cc] = 0.f;
  }

  int kv_end = Tk;
  if (causal) {
    const int64_t last = static_cast<int64_t>(q_offset) + q0 + kSimtBQ;
    kv_end = last < 0 ? 0 : (last < Tk ? static_cast<int>(last) : Tk);
  }
  float* myP = sP + warp * kSimtRows * 32;
  for (int k0 = 0; k0 < kv_end; k0 += kSimtBK) {
    __syncthreads();  // Q is staged / the previous tile is consumed
    for (int i = tid; i < kSimtBK * hd; i += kSimtThreads) {
      const int r = i / hd;
      const int c = i - r * hd;
      const bool in = k0 + r < Tk;
      sK[r * (hd + 1) + c] = in ? to_f32(kb[(k0 + r) * kv_stride + c]) : 0.f;
      sV[r * hd + c] = in ? to_f32(vb[(k0 + r) * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    float alpha[kSimtRows];
#pragma unroll
    for (int j = 0; j < kSimtRows; ++j) {
      const int row = warp * kSimtRows + j;
      const float* qr = sQ + row * hd;
      const float* kr = sK + lane * (hd + 1);
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s += qr[c] * kr[c];
      s *= scale;
      const bool live = key < Tk && (!causal || key <= q_offset + q0 + row);
      if (!live) s = -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      mx = fmaxf(mx, m[j]);
      const float base = mx == -INFINITY ? 0.f : mx;
      const float p = expf(s - base);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      alpha[j] = expf(m[j] - base);
      l[j] = l[j] * alpha[j] + psum;
      m[j] = mx;
      myP[j * 32 + lane] = p;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSimtRows; ++j) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        float acc = o[j][cc] * alpha[j];
        if (c < hd) {
          for (int t = 0; t < kSimtBK; ++t) acc += myP[j * 32 + t] * sV[t * hd + c];
        }
        o[j][cc] = acc;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < kSimtRows; ++j) {
    const int row = q0 + warp * kSimtRows + j;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < hd) ob[row * q_stride + c] = from_f32<T>(o[j][cc] * inv);
    }
  }
}

template <typename T, int NC>
int launch_simt(const void* q, const void* k, const void* v, void* out, int B,
                int Tq, int Tk, int H, int KVH, int hd, int causal,
                int q_offset, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(hd);
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      fa_simt_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (Tq + kSimtBQ - 1) / kSimtBQ;
  const unsigned grid = static_cast<unsigned>(n_qtiles) * B * H;
  fa_simt_kernel<T, NC><<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, H, KVH, hd,
      causal, q_offset, n_qtiles, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* out,
                  int B, int Tq, int Tk, int H, int KVH, int hd, int causal,
                  int q_offset, cudaStream_t s) {
  if (hd <= 32)
    return launch_simt<T, 1>(q, k, v, out, B, Tq, Tk, H, KVH, hd, causal, q_offset, s);
  if (hd <= 64)
    return launch_simt<T, 2>(q, k, v, out, B, Tq, Tk, H, KVH, hd, causal, q_offset, s);
  if (hd <= 128)
    return launch_simt<T, 4>(q, k, v, out, B, Tq, Tk, H, KVH, hd, causal, q_offset, s);
  return launch_simt<T, 8>(q, k, v, out, B, Tq, Tk, H, KVH, hd, causal, q_offset, s);
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Tq, int Tk, int H, int KVH, int causal, int q_offset,
               cudaStream_t stream) {
  const int n_qtiles = (Tq + kMmaBQ - 1) / kMmaBQ;
  const unsigned grid = static_cast<unsigned>(n_qtiles) * B * H;
  fa_mma_kernel<HD><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Tq, Tk, H, KVH, causal, q_offset, n_qtiles,
      kLog2e / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, Tq, H, hd], k/v [B, Tk, KVH, hd], out [B, Tq, H, hd] contiguous;
// dtype 0 = float32, 1 = bfloat16; variant 0 = simt (any dtype, hd <= 256),
// 1 = mma (bf16, hd 64 or 128, 16-byte aligned rows).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int64_t B, int64_t Tq, int64_t Tk,
                          int64_t H, int64_t KVH, int64_t hd, int64_t causal,
                          int64_t q_offset, int64_t dtype, int64_t variant,
                          int64_t device, void* stream) {
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), tq = static_cast<int>(Tq),
            tk = static_cast<int>(Tk), nh = static_cast<int>(H),
            nkv = static_cast<int>(KVH), d = static_cast<int>(hd),
            c = static_cast<int>(causal), off = static_cast<int>(q_offset);
  if (variant == 1 && dtype == 1) {
    if (d == 64) return launch_mma<64>(q, k, v, out, b, tq, tk, nh, nkv, c, off, s);
    if (d == 128) return launch_mma<128>(q, k, v, out, b, tq, tk, nh, nkv, c, off, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0 || d > kMaxSimtHd) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_simt<float>(q, k, v, out, b, tq, tk, nh, nkv, d, c, off, s);
  if (dtype == 1)
    return dispatch_simt<__nv_bfloat16>(q, k, v, out, b, tq, tk, nh, nkv, d, c, off, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
