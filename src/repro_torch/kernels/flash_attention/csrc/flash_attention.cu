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
// balance point, so the tensor cores set the pace: 4 B H Tq Tk hd / 2
// flops for a causal square, 6.67 ms at 989 TFLOP/s for the prefill_32k
// head shape (Tq = Tk = 32768, H 24, hd 128).  Two variants:
//   - fa_ws_kernel (bf16, hd 64 or 128), warp-specialised for Hopper: a
//     block owns 128 query rows of one head; one producer warpgroup (one
//     thread of it issues the copies, setmaxnreg gives the group few
//     registers) keeps TMA loads of 128-row K and V tiles in a ring of 2
//     stages (128-byte swizzle, full/empty mbarrier pairs), and two
//     consumer warpgroups of 64 query rows each compute S = Q K^T with
//     wgmma.mma_async m64n128k16 (Q and K from shared memory, K-major),
//     the online softmax in f32 on the accumulators (exp2 with the scale
//     folded in), and O += P V with wgmma in the register-A form (the S
//     accumulators repacked to bf16 A fragments; V from shared memory with
//     the transpose bit).  TMA reads through a 3-D map [B, T, heads * hd],
//     so rows past T are zero-filled rather than the next batch's; keys
//     past Tk and above the diagonal are masked with -inf.  Tiles above
//     the diagonal are skipped whole; the heaviest (last) query tiles are
//     scheduled first, and the query heads of one KV head are neighbours
//     in the grid so that L2 serves them the same K/V tiles.  The tensor
//     maps are encoded on the host per call (cuTensorMapEncodeTiled, found
//     through cudaGetDriverEntryPointByVersion: the library links only the
//     runtime) and passed as __grid_constant__ parameters.
//   - fa_simt_kernel (f32, or bf16 at other head sizes): CUDA-core FMAs in
//     f32; a lane scores one key row of a 32-row tile for 8 query rows, and
//     P V accumulates over the lanes' columns.  It exists for the f32
//     parity path, not for speed.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda.h>
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
// bf16 warp-specialised variant: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kWsBM = 128;  // query rows of a block: 2 consumers x 64
constexpr int kWsBN = 128;  // keys of a K/V tile
constexpr int kWsStages = 2;
constexpr int kWsThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kSubCols = 64;     // bf16 columns of a 128-byte swizzle row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that
// never ends (a broken pipeline) traps, so it surfaces as a launch error
// instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// a [64 x rows] box of a 3-D tensor map into shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo,
                                               int sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving accesses of `r` across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D [64 x 128] (+)= A [64 x 16] B [16 x 128], A and B from shared memory
// (both K-major); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D [64 x 128] += A [64 x 16] B [16 x 128], A from registers, B from
// shared memory stored N-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D [64 x 64] += A [64 x 16] B [16 x 64], A from registers, B from
// shared memory stored N-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

// Shared memory of a block.  A tile [rows][HD] is HD / 64 sub-tiles of
// [rows][64] bf16, each row 128 bytes in TMA's 128-byte swizzle; every
// sub-tile starts on a 1024-byte boundary, as the swizzle needs.
template <int HD>
struct WsSmem {
  __nv_bfloat16 q[kWsBM * HD];
  __nv_bfloat16 k[kWsStages][kWsBN * HD];
  __nv_bfloat16 v[kWsStages][kWsBN * HD];
  uint64_t full[kWsStages];
  uint64_t empty[kWsStages];
  uint64_t qbar;
};

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    fa_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, int Tq, int Tk, int H,
                 int KVH, int causal, int q_offset, int n_qtiles,
                 float scale_log2) {
  constexpr int NSUB = HD / kSubCols;
  constexpr int SUB_Q = kWsBM * kSubCols;  // elements of a sub-tile
  constexpr int SUB_KV = kWsBN * kSubCols;
  constexpr int NO = HD / 2;  // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  WsSmem<HD>& sm = *reinterpret_cast<WsSmem<HD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int BH = gridDim.x / n_qtiles;
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  int kv_end = Tk;
  if (causal) {
    const int64_t last = static_cast<int64_t>(q_offset) + (qtile + 1) * kWsBM;
    kv_end = last < 0 ? 0 : (last < Tk ? static_cast<int>(last) : Tk);
  }
  const int n_kt = (kv_end + kWsBN - 1) / kWsBN;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(&sm.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.qbar, kWsBM * HD * 2);
      for (int c = 0; c < NSUB; ++c)
        tma_load_3d(sm.q + c * SUB_Q, &tm_q, &sm.qbar, h * HD + c * kSubCols,
                    qtile * kWsBM, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kWsStages;
        mbar_wait(&sm.empty[st], ((kt / kWsStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * kWsBN * HD * 2);
        for (int c = 0; c < NSUB; ++c) {
          tma_load_3d(sm.k[st] + c * SUB_KV, &tm_k, &sm.full[st],
                      kvh * HD + c * kSubCols, kt * kWsBN, b);
          tma_load_3d(sm.v[st] + c * SUB_KV, &tm_v, &sm.full[st],
                      kvh * HD + c * kSubCols, kt * kWsBN, b);
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows [qtile * 128 + (wg - 1) * 64, +64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row_a = qtile * kWsBM + cw * 64 + warp * 16 + gid;
  const int row_b = row_a + 8;
  const int pos_a = q_offset + row_a;
  const int pos_b = q_offset + row_b;
  const int first_pos = q_offset + qtile * kWsBM + cw * 64;
  const int last_pos = first_pos + 63;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  mbar_wait(&sm.qbar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kWsStages;
    const int k0 = kt * kWsBN;
    mbar_wait(&sm.full[st], (kt / kWsStages) & 1);
    // a tile wholly above this warpgroup's diagonal adds nothing
    const bool live = !(causal && k0 > last_pos);
    if (live) {
      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int c = ks / 4, off = (ks % 4) * 16;  // sub-tile, column
        const uint64_t da = wgmma_desc(sm.q + c * SUB_Q + cw * 64 * kSubCols + off, 16, 1024);
        const uint64_t db = wgmma_desc(sm.k[st] + c * SUB_KV + off, 16, 1024);
        wgmma_ss_n128(s, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // mask the diagonal and the ragged edge.  Accumulator 4 n + e holds
      // row gid (e < 2) or gid + 8, key k0 + 8 n + 2 tig + (e & 1)
      const bool need_mask =
          k0 + kWsBN > Tk || (causal && k0 + kWsBN - 1 > first_pos);
      if (need_mask) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + tig * 2 + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            if (key >= Tk || (causal && key > pos)) s[4 * n + e] = -INFINITY;
          }
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
      }
      // running max in the exp2 domain (the scale is positive); a row with
      // no live key yet keeps m = -inf and subtracts 0 instead
      mx_a = fmaxf(m_a, mx_a * scale_log2);
      mx_b = fmaxf(m_b, mx_b * scale_log2);
      const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
      const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
      const float alpha_a = ex2(m_a - base_a);
      const float alpha_b = ex2(m_b - base_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -base_a));
        s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -base_a));
        s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -base_b));
        s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -base_b));
        sum_a += s[4 * n] + s[4 * n + 1];
        sum_b += s[4 * n + 2] + s[4 * n + 3];
      }
      l_a = l_a * alpha_a + sum_a;  // this thread's columns; summed at the end
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        o[4 * n] *= alpha_a;
        o[4 * n + 1] *= alpha_a;
        o[4 * n + 2] *= alpha_b;
        o[4 * n + 3] *= alpha_b;
      }

      // O += P V: keys 16 kk .. 16 kk + 15 are accumulators 8 kk .. 8 kk + 7,
      // the A fragment of k-step kk; V's rows of that k-step start 16 kk
      // rows into each sub-tile, sub-tiles are the N-major atoms (LBO)
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t db = wgmma_desc(sm.v[st] + kk * 16 * kSubCols,
                                       SUB_KV * 2, 1024);
        wgmma_rs<HD>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * Tq * H + h) * HD;
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int c = n * 8 + tig * 2;
    if (row_a < Tq)
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + c) =
          pack_bf16(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (row_b < Tq)
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + c) =
          pack_bf16(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
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


// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links only the runtime)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [B, T, heads * hd] bf16, boxes of [1, rows, 64] in the 128-byte swizzle;
// rows past T read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int width,
              int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(width) * 2 * T};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSubCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_ws(const void* q, const void* k, const void* v, void* out, int B,
              int Tq, int Tk, int H, int KVH, int causal, int q_offset,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Tq, H * HD, kWsBM) ||
      !make_map(&tk, k, B, Tk, KVH * HD, kWsBN) ||
      !make_map(&tv, v, B, Tk, KVH * HD, kWsBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(WsSmem<HD>)) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      fa_ws_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (Tq + kWsBM - 1) / kWsBM;
  const unsigned grid = static_cast<unsigned>(n_qtiles) * B * H;
  fa_ws_kernel<HD><<<grid, kWsThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Tq, Tk, H, KVH, causal,
      q_offset, n_qtiles, kLog2e / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, Tq, H, hd], k/v [B, Tk, KVH, hd], out [B, Tq, H, hd] contiguous;
// dtype 0 = float32, 1 = bfloat16; variant 0 = simt (any dtype, hd <= 256),
// 1 = ws (bf16, hd 64 or 128, 16-byte aligned tensors).
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
    if (d == 64) return launch_ws<64>(q, k, v, out, b, tq, tk, nh, nkv, c, off, s);
    if (d == 128) return launch_ws<128>(q, k, v, out, b, tq, tk, nh, nkv, c, off, s);
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
