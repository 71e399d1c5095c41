// K4 on Hopper: the fleet FIFO solver of an event-core cluster day.
//
// Replaces the jitted lax.scan of the reference
//   src/repro/serving/event_core.py  _load_jax.fleet_scan (built at :198,
//   driven by fleet_fifo_finish :240 and _run_fleet_group :297)
// which advances S padded streams of one k at once over a transposed
// [N_pad, S_pad] time-major layout (power-of-two padding and an ACT mask
// keep XLA's compile cache small; the card needs neither).
//
// Function, per stream s with jobs t = 0 .. n_s - 1 (ready r, duration d)
// served FIFO by the earliest free of k_s servers with free times W:
//   a = argmin(W);  f = W[a];  e = (r > f ? r : f) + d;  W[a] = e;  end_t = e
// ends [total] f64 in the ragged layout of the inputs, and the final W
// [S, kmax] f64 (row s holds its k_s free times unsorted, then +inf; the
// host sorts).
// This is what engine._sweep computes one heap op per job, bitwise: the
// step uses exactly the sweep's operands (a compare-select, then one IEEE
// double add: no multiply, so nothing to contract into an FMA, and no
// fmax, whose signed zeros and NaNs differ), and an argmin tie picks a
// slot, never a value, so the free-time multiset is the same either way.
//
// What bounds it: the dependent chain, not bytes.  Step t + 1 needs step
// t's W, so a stream's time is its step count times the latency of one
// step (argmin over k, a select, an add), and a launch lasts as long as
// its longest stream (a full-width day: ~7 streams a group, k up to 17,
// chains up to ~150,000 steps); each job moves 24 bytes.  This design:
//   - One thread a stream over a ragged layout (int64 offsets [S + 1]): no
//     padding to the longest stream, no mask.
//   - The k free times live in registers: k is a compile-time bucket
//     (1/2/4/8/16/32), the bucket's unused slots hold +inf and lose every
//     tie to a real slot, so they are never picked.  The argmin is a tree
//     of depth log2(bucket) over adjacent pairs (a strict < keeps the
//     lower slot on a tie, as torch.argmin and jnp.argmin do), and the
//     write-back is a select on every slot, so no register is indexed at
//     run time.  A k above 32 takes a generic instance that works on its
//     row of the state output in memory (the reference takes any k).
//   - ready and dur are loaded a block of kAhead jobs ahead of the
//     recurrence (they do not depend on it), so the chain never waits on
//     a load.
//   - Every wide group of a fleet_fifo_finish call goes in one launch, so
//     their chains overlap; the host lays the streams out so that each
//     warp holds streams of one bucket (lanes [2, n_lanes]: stream index
//     or -1, and k), and the bucket switch is warp-uniform.  One warp a
//     block, so the few warps of a launch spread over the SMs.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // threads a block: one warp
constexpr int kAhead = 8;   // jobs loaded ahead of the recurrence
constexpr int kMaxBucket = 32;

struct Args {
  const double* ready;
  const double* dur;
  const int64_t* offsets;  // [S + 1]
  const int32_t* lanes;    // [2, n_lanes]: stream (or -1), then its k
  const double* free0;     // [S, kmax]
  double* ends;            // [total]
  double* state;           // [S, kmax]
  int64_t n_lanes;
  int64_t kmax;
};

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// Argmin over K registers by a tree of adjacent pairs; the left (lower)
// slot wins a tie, so the result is the first minimal slot.  The level
// loop has a constant trip count, so both loops unroll and every index is
// a constant: the tree stays in registers.
template <int K>
__device__ __forceinline__ int argmin_tree(const double (&w)[K], double& m) {
  double v[K];
  int ix[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = w[j];
    ix[j] = j;
  }
#pragma unroll
  for (int level = 0; level < ilog2(K); ++level) {
#pragma unroll
    for (int j = 0; j < (K >> (level + 1)); ++j) {
      const bool right = v[2 * j + 1] < v[2 * j];
      v[j] = right ? v[2 * j + 1] : v[2 * j];
      ix[j] = right ? ix[2 * j + 1] : ix[2 * j];
    }
  }
  m = v[0];
  return ix[0];
}

template <int K>
__device__ void run_bucket(const Args& a, int64_t s, int k) {
  const int64_t lo = a.offsets[s];
  const int64_t n = a.offsets[s + 1] - lo;
  const double* r_in = a.ready + lo;
  const double* d_in = a.dur + lo;
  double* e_out = a.ends + lo;
  const double* f0 = a.free0 + s * a.kmax;

  double w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = j < k ? f0[j] : CUDART_INF;

  double rn[kAhead], dn[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    rn[u] = u < n ? r_in[u] : 0.0;
    dn[u] = u < n ? d_in[u] : 0.0;
  }
  for (int64_t base = 0; base < n; base += kAhead) {
    double rc[kAhead], dc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      rc[u] = rn[u];
      dc[u] = dn[u];
    }
    const int64_t next = base + kAhead;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      rn[u] = next + u < n ? r_in[next + u] : 0.0;
      dn[u] = next + u < n ? d_in[next + u] : 0.0;
    }
    const int todo = n - base < kAhead ? static_cast<int>(n - base) : kAhead;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < todo) {
        double f;
        const int am = argmin_tree<K>(w, f);
        const double r = rc[u];
        const double e = __dadd_rn(r > f ? r : f, dc[u]);
#pragma unroll
        for (int j = 0; j < K; ++j) w[j] = j == am ? e : w[j];
        e_out[base + u] = e;
      }
    }
  }
  double* st = a.state + s * a.kmax;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < a.kmax) st[j] = w[j];
  for (int64_t j = K; j < a.kmax; ++j) st[j] = CUDART_INF;
}

// Any k: the row is the stream's row of the state output, in memory.
__device__ void run_generic(const Args& a, int64_t s, int k) {
  const int64_t lo = a.offsets[s];
  const int64_t n = a.offsets[s + 1] - lo;
  double* w = a.state + s * a.kmax;
  const double* f0 = a.free0 + s * a.kmax;
  for (int j = 0; j < k; ++j) w[j] = f0[j];
  for (int64_t t = 0; t < n; ++t) {
    const double r = a.ready[lo + t];
    const double d = a.dur[lo + t];
    double f = w[0];
    int am = 0;
    for (int j = 1; j < k; ++j) {
      const double x = w[j];
      if (x < f) {
        f = x;
        am = j;
      }
    }
    const double e = __dadd_rn(r > f ? r : f, d);
    w[am] = e;
    a.ends[lo + t] = e;
  }
  for (int64_t j = k; j < a.kmax; ++j) w[j] = CUDART_INF;
}

__global__ void __launch_bounds__(kLanes) fleet_fifo_kernel(const Args a) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int64_t s = a.lanes[lane];
  if (s < 0) return;
  const int k = a.lanes[a.n_lanes + lane];
  if (k <= 1) {
    run_bucket<1>(a, s, k);
  } else if (k <= 2) {
    run_bucket<2>(a, s, k);
  } else if (k <= 4) {
    run_bucket<4>(a, s, k);
  } else if (k <= 8) {
    run_bucket<8>(a, s, k);
  } else if (k <= 16) {
    run_bucket<16>(a, s, k);
  } else if (k <= kMaxBucket) {
    run_bucket<kMaxBucket>(a, s, k);
  } else {
    run_generic(a, s, k);
  }
}

}  // namespace

extern "C" {

// ready, dur [total] f64; offsets [S + 1] int64; lanes [2, n_lanes] int32
// (n_lanes a multiple of 32; each warp's streams share a bucket); free0,
// state [S, kmax] f64; ends [total] f64.  Contiguous, on `device`.
int repro_fleet_fifo(const void* ready, const void* dur, const void* offsets,
                     const void* lanes, const void* free0, void* ends,
                     void* state, int64_t n_lanes, int64_t kmax,
                     int64_t device, void* stream) {
  if (n_lanes <= 0 || n_lanes % kLanes != 0 || kmax <= 0 ||
      n_lanes / kLanes >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const double*>(ready),
               static_cast<const double*>(dur),
               static_cast<const int64_t*>(offsets),
               static_cast<const int32_t*>(lanes),
               static_cast<const double*>(free0),
               static_cast<double*>(ends),
               static_cast<double*>(state),
               n_lanes,
               kmax};
  fleet_fifo_kernel<<<static_cast<unsigned>(n_lanes / kLanes), kLanes, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_fleet_fifo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
