// K3 on Hopper: split-KV flash decode (one query token against a KV cache),
// from a bf16/f32 cache or straight from the int8 cache and its scales.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_decode.py  flash_decode_partials
//   (body _decode_kernel; flash_decode_pallas adds the final divide)
// whose grid walks (batch x kv head, KV chunk) and emits per-chunk softmax
// partials that lse_combine merges outside the kernel.  The int8 entry also
// takes in the dequantisation the reference runs eagerly around its K3 call
// (src/repro/models/transformer.py:166-185): k = int8 x scale in q's dtype.
//
// Function: for each batch b, kv head j and query head h = j * G + g,
//   s[r] = q[b, h] . k[b, r, j] / sqrt(hd)    for live rows r,
//   live: kv_offset + r < kv_len  (global position of local row r)
//   m = max_r s[r],  l = sum_r exp(s[r] - m),  o = sum_r exp(s[r] - m) v[b, r, j]
// in f32, q [B, 1, H, hd] and k/v [B, S, KVH, hd] in q's dtype, or k/v
// int8 with f32 scales [B, S, KVH, 1], dequantised exactly as the eager
// path rounds: bf16(int8) * bf16(scale) rounded to bf16, or in f32 the f32
// product.  With no live row the partial is exactly m = -1e30, l = 0,
// o = 0.  Output either the merged partials (m, l [B, KVH, G, 1],
// o [B, KVH, G, hd], f32) or o / max(l, 1e-30) as [B, 1, H, hd] in q's
// dtype.
//
// What bounds it: bytes.  Each live K and V row is read once (2 x hd x 2
// bytes in bf16, 2 x hd + 8 bytes from int8) for 4 x G x hd flops, about
// 3 flops a byte at G = 3, two orders below the card's balance point.  At
// decode_32k (B 16, S 32768, KVH 8, hd 128) that is 0.641 ms in bf16 and
// 0.330 ms from int8 at 3.35 TB/s.  The design keeps bytes in flight and
// the arithmetic off the loads' path:
//   - block = (batch x kv head, split of the live rows), 4 warps; the
//     launcher splits only the live range [0, kv_len - kv_offset), so a
//     short cache in a long buffer costs what it holds;
//   - a ring of kStages stages of 64-row K and V tiles (and the rows'
//     scales) in dynamic shared memory, filled by cp.async 16-byte copies
//     (4-byte ones for the scales); tile i + kStages - 1 is in flight
//     while tile i is computed (~64 KB a block, two or more blocks an SM);
//     rows past the split are zero-filled by the copy and masked;
//   - S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16 bf16,
//     f32 accumulators): the G <= 8 query rows of the kv head are the A
//     operand padded to 16 rows with zeros, each warp takes 16 keys of a
//     tile, and P goes from the S accumulators straight into A fragments.
//     The head dimension and the keys are permuted inside the fragments
//     (the products do not depend on the order) so that each thread reads
//     whole 16-byte (bf16) or 8-byte (int8) pieces of its rows; the tiles
//     are XOR-swizzled so those reads are free of bank conflicts.  The
//     int8 entry dequantises in registers while it builds the B fragments
//     (byte permutes, a float subtraction and a bf16x2 multiply, which
//     round as the eager path does, instead of the conversion pipe), so
//     the bf16 and int8 entries run the same products on the same values:
//     on an eagerly dequantised cache they agree bitwise;
//   - f32 runs a CUDA-core variant (the parity path): 16-byte loads per
//     lane group, 4 rows deep, shuffle-tree dot products; so does a bf16
//     cache at head sizes other than 64, 128 and 256 (8-byte loads);
//   - online softmax in f32 per warp, merged across warps in shared memory
//     and across splits by a second small kernel (decode_combine_kernel)
//     that also applies the final divide when the attention is asked for.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxG = 8;
constexpr int kMaxHd = 256;

// ---------------------------------------------------------------------------
// cp.async and mma helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when `bytes` is 0
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // A rows 8-15 (a1, a3) are the zero padding of the G <= 8 query rows
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Dequantisation without the conversion pipe (a quarter of the FMA rate,
// which would bound the int8 entry): byte i of u = w ^ 0x80808080 is
// x + 128 for the int8 x, so a byte permute builds the float 2^23 + 128 + x
// and one subtraction leaves x exactly.  |x| <= 128 has at most 8
// significant bits, so the float's high half is x in bf16.
__device__ __forceinline__ uint32_t i8_as_f32_bits(uint32_t u, int i) {
  const float f =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  return __float_as_uint(f);
}

// the bf16 pair (high half of a, high half of b)
__device__ __forceinline__ uint32_t hi_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632u);
}

// bf16 x bf16 rounded to bf16, pairwise: the eager path's multiply (adding
// -0 leaves the correctly rounded product)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// a row scale rounded to bf16, as the bits of the pair (scale, scale)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(x)));
}

// ---------------------------------------------------------------------------
// tensor-core variant: q bf16; K/V bf16, or int8 with f32 row scales
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps x 16 keys of a tile
constexpr int kTile = 64;
constexpr int kRingBytes = 96 * 1024;

template <int HD, bool kInt8>
struct TcCfg {
  static constexpr int kRowBytes = kInt8 ? HD : 2 * HD;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kScaleBytes = kInt8 ? kTile * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kScaleBytes;
  static constexpr int kFit = kRingBytes / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 6 ? 6 : kFit);
  static constexpr int kMergeBytes = 4 * kMaxG * HD * 4;
  static constexpr int kSmem = kStages * kStageBytes > kMergeBytes
                                   ? kStages * kStageBytes
                                   : kMergeBytes;
};

// 16-byte chunk c of tile row r lies at chunk swz(r, c); K and V tiles are
// read in different patterns, so each has its own XOR
template <bool kInt8, int kChunks>
__device__ __forceinline__ int swz_k(int r, int c) {
  const int x = kInt8 ? (((r & 1) << 1) | (((r >> 2) & 1) << 2))
                      : ((r & 1) << 2);
  return c ^ (x & (kChunks - 1));
}
template <int kChunks>
__device__ __forceinline__ int swz_v(int r, int c) {
  return c ^ ((((r >> 2) & 3) << 1) & (kChunks - 1));
}

// One block: kv head `bh` (= b * KVH + j), rows [split * split_len,
// min(n_live, (split + 1) * split_len)).  Writes the split's partial
// (pm, pl [BH, n_splits, G]; po [BH, n_splits, G, hd]).
template <int HD, bool kInt8>
__global__ void __launch_bounds__(kTcThreads)
    decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const void* __restrict__ k, const void* __restrict__ v,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale, float* __restrict__ pm,
                     float* __restrict__ pl, float* __restrict__ po,
                     int64_t S, int KVH, int G, int64_t n_live,
                     int64_t split_len, int n_splits, float scale) {
  using Cfg = TcCfg<HD, kInt8>;
  constexpr int RB = Cfg::kRowBytes;
  constexpr int NCH = Cfg::kChunks;
  constexpr int KS = HD / 16;  // k-steps of S = Q K^T
  constexpr int NO = HD / 8;   // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float sm_m[4][kMaxG];
  __shared__ float sm_l[4][kMaxG];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int64_t bh = blockIdx.x / n_splits;
  const int split = static_cast<int>(blockIdx.x - bh * n_splits);
  const int64_t b = bh / KVH;
  const int64_t j = bh - b * KVH;
  const int64_t r0 = static_cast<int64_t>(split) * split_len;
  const int64_t r1 = r0 + split_len < n_live ? r0 + split_len : n_live;
  const int n_tiles = static_cast<int>((r1 - r0 + kTile - 1) / kTile);

  // global row r of this kv head: byte offset r * row_stride from *_base
  const int64_t row_stride = static_cast<int64_t>(KVH) * RB;
  const int64_t head0 = (b * S * KVH + j);  // element row of (b, 0, j)
  const unsigned char* k_base =
      static_cast<const unsigned char*>(k) + head0 * RB;
  const unsigned char* v_base =
      static_cast<const unsigned char*>(v) + head0 * RB;
  const float* ks_base = kInt8 ? kscale + head0 : nullptr;
  const float* vs_base = kInt8 ? vscale + head0 : nullptr;

  auto stage_k = [&](int st) { return smem + st * Cfg::kStageBytes; };
  auto stage_v = [&](int st) { return stage_k(st) + Cfg::kTileBytes; };
  auto stage_ks = [&](int st) {
    return reinterpret_cast<float*>(stage_k(st) + 2 * Cfg::kTileBytes);
  };
  auto stage_vs = [&](int st) { return stage_ks(st) + kTile; };

  auto load_tile = [&](int t, int st) {
    const int64_t row0 = r0 + static_cast<int64_t>(t) * kTile;
    unsigned char* dk = stage_k(st);
    unsigned char* dv = stage_v(st);
    for (int i = tid; i < kTile * NCH; i += kTcThreads) {
      const int r = i / NCH;
      const int c = i - r * NCH;
      const bool ok = row0 + r < r1;
      const int64_t off = (ok ? row0 + r : r0) * row_stride + c * 16;
      cp_async_16(dk + r * RB + swz_k<kInt8, NCH>(r, c) * 16, k_base + off,
                  ok ? 16 : 0);
      cp_async_16(dv + r * RB + swz_v<NCH>(r, c) * 16, v_base + off,
                  ok ? 16 : 0);
    }
    if constexpr (kInt8) {
      for (int i = tid; i < 2 * kTile; i += kTcThreads) {
        const int r = i & (kTile - 1);
        const bool ok = row0 + r < r1;
        const int64_t off = (ok ? row0 + r : r0) * KVH;
        if (i < kTile)
          cp_async_4(stage_ks(st) + r, ks_base + off, ok ? 4 : 0);
        else
          cp_async_4(stage_vs(st) + r, vs_base + off, ok ? 4 : 0);
      }
    }
  };

  // start the ring before anything else
#pragma unroll
  for (int s = 0; s < Cfg::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // Q rows g = gid < G as A fragments (rows 8-15 are zero).  k-step ks,
  // thread tig takes dims base + {0,1} (a0) and base + {2,3} (a2) with
  // base = ((ks / 2) * 4 + tig) * 8 + (ks % 2) * 4: the same dims its K
  // pieces hold
  uint32_t qa[KS][2];
  {
    const __nv_bfloat16* qr = q + (bh * G + gid) * HD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int base = ((ks >> 1) * 4 + tig) * 8 + (ks & 1) * 4;
      qa[ks][0] = gid < G ? *reinterpret_cast<const uint32_t*>(qr + base) : 0u;
      qa[ks][1] =
          gid < G ? *reinterpret_cast<const uint32_t*>(qr + base + 2) : 0u;
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m = kNegInf, l = 0.f;
  const int kw = warp * 16;  // this warp's keys in a tile

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<Cfg::kStages - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    if (t + Cfg::kStages - 1 < n_tiles)
      load_tile(t + Cfg::kStages - 1, (t + Cfg::kStages - 1) % Cfg::kStages);
    cp_async_commit();

    const int st = t % Cfg::kStages;
    const unsigned char* sk = stage_k(st);
    const unsigned char* sv = stage_v(st);

    // S = Q K^T.  S column n of n-tile nt is key kw + pi(nt, n), with
    // pi(nt, n) = (n / 2) * 4 + nt * 2 + n % 2: the thread holding columns
    // 2 tig, 2 tig + 1 of both n-tiles holds keys kw + 4 tig + {0..3}
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const int r = kw + (gid >> 1) * 4 + nt * 2 + (gid & 1);
      uint32_t sb = 0;  // the row's scale in bf16, twice
      if constexpr (kInt8) sb = bf16_bits(stage_ks(st)[r]) * 0x10001u;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        uint32_t kx[4];  // dims (c * 4 + tig) * 8 + {0..7} as bf16 pairs
        if constexpr (kInt8) {
          const int u = c * 4 + tig;  // 8-byte piece of the int8 row
          const uint2 w = *reinterpret_cast<const uint2*>(
              sk + r * RB + swz_k<true, NCH>(r, u >> 1) * 16 + (u & 1) * 8);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint32_t word = (p < 2 ? w.x : w.y) ^ 0x80808080u;
            const int i = (p & 1) * 2;
            kx[p] = mul_bf16x2(hi_pair(i8_as_f32_bits(word, i),
                                       i8_as_f32_bits(word, i + 1)), sb);
          }
        } else {
          const uint4 w = *reinterpret_cast<const uint4*>(
              sk + r * RB + swz_k<false, NCH>(r, c * 4 + tig) * 16);
          kx[0] = w.x;
          kx[1] = w.y;
          kx[2] = w.z;
          kx[3] = w.w;
        }
        mma_bf16(s[nt], qa[2 * c][0], qa[2 * c][1], kx[0], kx[1]);
        mma_bf16(s[nt], qa[2 * c + 1][0], qa[2 * c + 1][1], kx[2], kx[3]);
      }
    }

    // online softmax of row gid over keys kw + 4 tig + {0..3}
    const int64_t key0 = r0 + static_cast<int64_t>(t) * kTile + kw + 4 * tig;
    float x[4] = {s[0][0], s[0][1], s[1][0], s[1][1]};
    float mx = m;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = key0 + e < r1 ? x[e] * scale : -INFINITY;
      mx = fmaxf(mx, x[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float alpha = __expf(m - mx);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __expf(x[e] - mx);
    l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
    m = mx;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    const uint32_t pa0 = pack_bf16(p[0], p[1]);  // k positions 2 tig, +1
    const uint32_t pa2 = pack_bf16(p[2], p[3]);  // k positions 2 tig + 8, +9

    // O += P V.  k positions {2 tig, 2 tig + 1} / {2 tig + 8, 2 tig + 9}
    // are V rows kw + 4 tig + {0, 1} / {2, 3}; B column n of n-tile
    // nt = c * 8 + e is dim (n + 8 c) * 8 + e, so the thread (as loader of
    // column gid) reads whole pieces of its four rows
    const int vr = kw + 4 * tig;
    uint32_t sv01 = 0, sv23 = 0;  // the rows' scales in bf16, in pairs
    if constexpr (kInt8) {
      const float* vsc = stage_vs(st);
      sv01 = bf16_bits(vsc[vr]) | (bf16_bits(vsc[vr + 1]) << 16);
      sv23 = bf16_bits(vsc[vr + 2]) | (bf16_bits(vsc[vr + 3]) << 16);
    }
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      const int u = gid + 8 * c;  // dims u * 8 + {0..7}
      uint32_t b0[8], b1[8];
      if constexpr (kInt8) {
        uint2 w[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          w[rr] = *reinterpret_cast<const uint2*>(
              sv + (vr + rr) * RB + swz_v<NCH>(vr + rr, u >> 1) * 16 +
              (u & 1) * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = e & 3;
          uint32_t x[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            x[rr] = i8_as_f32_bits((e < 4 ? w[rr].x : w[rr].y) ^ 0x80808080u,
                                   i);
          b0[e] = mul_bf16x2(hi_pair(x[0], x[1]), sv01);
          b1[e] = mul_bf16x2(hi_pair(x[2], x[3]), sv23);
        }
      } else {
        uint4 w[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          w[rr] = *reinterpret_cast<const uint4*>(
              sv + (vr + rr) * RB + swz_v<NCH>(vr + rr, u) * 16);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = e >> 1;
          const unsigned sel = (e & 1) ? 0x7632u : 0x5410u;
          const uint32_t x0 = i == 0 ? w[0].x : i == 1 ? w[0].y : i == 2 ? w[0].z : w[0].w;
          const uint32_t x1 = i == 0 ? w[1].x : i == 1 ? w[1].y : i == 2 ? w[1].z : w[1].w;
          const uint32_t x2 = i == 0 ? w[2].x : i == 1 ? w[2].y : i == 2 ? w[2].z : w[2].w;
          const uint32_t x3 = i == 0 ? w[3].x : i == 1 ? w[3].y : i == 2 ? w[3].z : w[3].w;
          b0[e] = __byte_perm(x0, x1, sel);
          b1[e] = __byte_perm(x2, x3, sel);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) mma_bf16(o[c * 8 + e], pa0, pa2, b0[e], b1[e]);
    }
  }
  cp_async_wait<0>();

  // merge the 4 lanes of each row, then the warps; the ring is reused
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  __syncthreads();
  float* sm_o = reinterpret_cast<float*>(smem);  // [4][kMaxG][HD]
  if (gid < G) {
    float* dst = sm_o + (warp * kMaxG + gid) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      // accumulator columns 2 tig, 2 tig + 1 of n-tile n = c * 8 + e
      const int c = n >> 3, e = n & 7;
      dst[(2 * tig + 8 * c) * 8 + e] = o[n][0];
      dst[(2 * tig + 1 + 8 * c) * 8 + e] = o[n][1];
    }
    if (tig == 0) {
      sm_m[warp][gid] = m;
      sm_l[warp][gid] = l;
    }
  }
  __syncthreads();

  const int64_t part = bh * n_splits + split;
  for (int idx = tid; idx < G * HD; idx += kTcThreads) {
    const int g = idx / HD;
    const int col = idx - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float a = __expf(sm_m[w][g] - mx);
      acc += sm_o[(w * kMaxG + g) * HD + col] * a;
      lsum += sm_l[w][g] * a;
    }
    po[(part * G + g) * HD + col] = acc;
    if (col == 0) {
      pm[part * G + g] = mx;
      pl[part * G + g] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 CUDA-core variant (the parity path): K/V f32, or int8 with f32 scales
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr int kV = 4;  // f32 elements of a 16-byte load

// four consecutive elements of a row as f32: a 16-byte load (f32), an
// 8-byte one (bf16), or 4 int8 times the row's scale, rounded as the eager
// f32 multiply rounds (no contraction into the dot product's FMA)
__device__ __forceinline__ void load4(const float* p, const float*,
                                      float (&x)[kV]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, const float*,
                                      float (&x)[kV]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, const float* sc,
                                      float (&x)[kV]) {
  const char4 t = *reinterpret_cast<const char4*>(p);
  const float s = *sc;
  x[0] = __fmul_rn(static_cast<float>(t.x), s);
  x[1] = __fmul_rn(static_cast<float>(t.y), s);
  x[2] = __fmul_rn(static_cast<float>(t.z), s);
  x[3] = __fmul_rn(static_cast<float>(t.w), s);
}

// One block: as decode_tc_kernel.  A row is L = hd / 4 lanes of 4
// elements; a warp holds 32 / L rows at once and unrolls 4 rows deep.
// Q is q's type: f32 (k/v f32 or int8) or bf16 (k/v bf16).
template <typename Q, typename Src, int G>
__global__ void __launch_bounds__(kThreads)
    decode_simt_kernel(const Q* __restrict__ q, const Src* __restrict__ k,
                       const Src* __restrict__ v,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       float* __restrict__ pm, float* __restrict__ pl,
                       float* __restrict__ po, int64_t S, int KVH, int hd,
                       int64_t n_live, int64_t split_len, int n_splits,
                       float scale) {
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_o[kWarps * G * 128];

  const int L = hd / kV;  // lanes per row, divides 32
  const int R = 32 / L;   // rows per warp pass
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

  float qf[G][kV];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load4(q + (bh * G + g) * hd + col * kV, nullptr, qf[g]);
#pragma unroll
    for (int i = 0; i < kV; ++i) qf[g][i] *= scale;
  }
  float m[G], l[G], o[G][kV];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i) o[g][i] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(KVH) * hd;
  const Src* kb = k + (b * S * KVH + j) * hd + col * kV;
  const Src* vb = v + (b * S * KVH + j) * hd + col * kV;
  const float* ksb = kscale == nullptr ? nullptr : kscale + b * S * KVH + j;
  const float* vsb = vscale == nullptr ? nullptr : vscale + b * S * KVH + j;
  const int slots = kWarps * R;
  const int64_t my_off = warp * R + slot;

  // the loop bound is uniform across the block, so every lane reaches the
  // shuffles; rows past r1 load nothing and weigh 0
  for (int64_t it = r0; it < r1; it += static_cast<int64_t>(slots) * kUnroll) {
    float kr[kUnroll][kV], vr[kUnroll][kV];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = it + u * slots + my_off;
      ok[u] = r < r1;
      if (ok[u]) {
        load4(kb + r * row_stride, ksb == nullptr ? nullptr : ksb + r * KVH,
              kr[u]);
        load4(vb + r * row_stride, vsb == nullptr ? nullptr : vsb + r * KVH,
              vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kV; ++i) acc += qf[g][i] * kr[u][i];
        s[u][g] = acc;
      }
    }
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
      for (int i = 0; i < kV; ++i) {
        float acc = o[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += p[u] * vr[u][i];
        o[g][i] = acc;
      }
      m[g] = mx;
    }
  }

  // merge the R lane groups of the warp.  Empty partials stay exactly empty.
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
      for (int i = 0; i < kV; ++i) {
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
      for (int i = 0; i < kV; ++i)
        sm_o[(warp * G + g) * hd + col * kV + i] = o[g][i];
      if (col == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

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

// ---------------------------------------------------------------------------
// merge over splits
// ---------------------------------------------------------------------------

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

// One block per kv head: merge its n_splits partials (n_splits may be 0:
// the empty partial).  With `out` set, writes o / max(l, 1e-30) in T at
// out[b, 0, j * G + g, :]; otherwise the merged m, l, o in f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ pm,
                          const float* __restrict__ pl,
                          const float* __restrict__ po, int n_splits, int G,
                          int hd, float* __restrict__ m_out,
                          float* __restrict__ l_out, float* __restrict__ o_out,
                          T* __restrict__ out) {
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  float* pm;
  float* pl;
  float* po;
  int64_t BH, S;
  int KVH, G, hd;
  int64_t n_live, split_len;
  int n_splits;
  float scale;
};

template <int HD, bool kInt8>
int launch_tc(const Args& a, cudaStream_t stream) {
  constexpr int smem = TcCfg<HD, kInt8>::kSmem;
  auto kernel = decode_tc_kernel<HD, kInt8>;
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(a.BH * a.n_splits), kTcThreads, smem,
           stream>>>(static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, a.ks,
                     a.vs, a.pm, a.pl, a.po, a.S, a.KVH, a.G, a.n_live,
                     a.split_len, a.n_splits, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q, typename Src, int G>
int launch_simt(const Args& a, cudaStream_t stream) {
  decode_simt_kernel<Q, Src, G><<<static_cast<unsigned>(a.BH * a.n_splits),
                                  kThreads, 0, stream>>>(
      static_cast<const Q*>(a.q), static_cast<const Src*>(a.k),
      static_cast<const Src*>(a.v), a.ks, a.vs, a.pm, a.pl, a.po, a.S, a.KVH,
      a.hd, a.n_live, a.split_len, a.n_splits, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q, typename Src>
int dispatch_simt(const Args& a, cudaStream_t s) {
  switch (a.G) {
    case 1: return launch_simt<Q, Src, 1>(a, s);
    case 2: return launch_simt<Q, Src, 2>(a, s);
    case 3: return launch_simt<Q, Src, 3>(a, s);
    case 4: return launch_simt<Q, Src, 4>(a, s);
    case 5: return launch_simt<Q, Src, 5>(a, s);
    case 6: return launch_simt<Q, Src, 6>(a, s);
    case 7: return launch_simt<Q, Src, 7>(a, s);
    case 8: return launch_simt<Q, Src, 8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kInt8>
int dispatch_tc(const Args& a, cudaStream_t s) {
  switch (a.hd) {
    case 64: return launch_tc<64, kInt8>(a, s);
    case 128: return launch_tc<128, kInt8>(a, s);
    case 256: return launch_tc<256, kInt8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [B, 1, KVH * G, hd], k/v [B, S, KVH, hd] contiguous and 16-byte
// aligned, dtype 0 = float32, 1 = bfloat16 (q's, and k/v's unless
// kv_int8).  kv_int8: k/v int8 with f32 scales ks/vs [B, S, KVH, 1].
// bf16: hd 64, 128 or 256 (tensor cores), or, from a bf16 cache, as f32
// (CUDA cores).  f32: 4 divides hd and hd / 4 divides 32.
// 1 <= G <= 8.  Scratch pm, pl [B * KVH * n_splits * G] and po [... * hd]
// f32.  `out` (q's dtype, [B, 1, H, hd]) selects the attention; when null,
// m_out/l_out [B, KVH, G, 1] and o_out [B, KVH, G, hd] receive the merged
// partials.
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, void* pm, void* pl,
                       void* po, void* m_out, void* l_out, void* o_out,
                       void* out, int64_t B, int64_t S, int64_t KVH,
                       int64_t G, int64_t hd, int64_t n_live,
                       int64_t split_len, int64_t n_splits, int64_t dtype,
                       int64_t kv_int8, int64_t device, void* stream) {
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (hd > kMaxHd || G < 1 || G > kMaxG || (kv_int8 && !(ks && vs)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<float*>(pm), static_cast<float*>(pl),
         static_cast<float*>(po), B * KVH, S, static_cast<int>(KVH),
         static_cast<int>(G), static_cast<int>(hd), n_live, split_len,
         static_cast<int>(n_splits), 1.0f / sqrtf(static_cast<float>(hd))};
  if (n_splits > 0) {
    const int bad = static_cast<int>(cudaErrorInvalidValue);
    const bool simt_hd = hd >= kV && hd % kV == 0 && 32 % (hd / kV) == 0;
    const bool tc_hd = hd == 64 || hd == 128 || hd == 256;
    int err;
    if (dtype == 0)
      err = !simt_hd  ? bad
            : kv_int8 ? dispatch_simt<float, int8_t>(a, s)
                      : dispatch_simt<float, float>(a, s);
    else if (dtype == 1)
      err = tc_hd     ? (kv_int8 ? dispatch_tc<true>(a, s)
                                 : dispatch_tc<false>(a, s))
            : kv_int8 || !simt_hd
                ? bad
                : dispatch_simt<__nv_bfloat16, __nv_bfloat16>(a, s);
    else
      err = bad;
    if (err != 0) return err;
  }
  const unsigned grid = static_cast<unsigned>(B * KVH);
  float* f_m = static_cast<float*>(m_out);
  float* f_l = static_cast<float*>(l_out);
  float* f_o = static_cast<float*>(o_out);
  if (dtype == 0)
    decode_combine_kernel<float><<<grid, kThreads, 0, s>>>(
        a.pm, a.pl, a.po, a.n_splits, a.G, a.hd, f_m, f_l, f_o,
        static_cast<float*>(out));
  else
    decode_combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        a.pm, a.pl, a.po, a.n_splits, a.G, a.hd, f_m, f_l, f_o,
        static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
