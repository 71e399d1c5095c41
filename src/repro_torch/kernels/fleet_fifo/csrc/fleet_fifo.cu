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
//   f = min(W);  e = (r > f ? r : f) + d;  W = W - {f} + {e};  end_t = e
// ends [total] f64 in the ragged layout of the inputs, and the final W
// [S, kmax] f64 (row s holds its k_s free times sorted ascending, then
// +inf), which is engine._sweep's np.sort(free).
// This is what engine._sweep computes one heap op per job, bitwise: an end
// depends only on the popped value, which is the minimum however the free
// times are kept, and the step uses exactly the sweep's operands (a
// compare-select, then one IEEE double add: no multiply to contract into an
// FMA, no fmax, whose signed zeros and NaNs differ).
//
// What bounds it: the dependent chain, not bytes.  Step t + 1 needs step
// t's W, so a stream's time is its step count times one step, and a launch
// lasts as long as its longest stream (a full-width day: ~7 streams a
// launch, k up to 17, chains up to ~150,000 steps); each job moves 24
// bytes.  The first kernel (one thread a stream, buckets of 1/2/4/8/16/32
// slots, an argmin tree, jobs loaded 8 ahead from device memory) ran
// 618 ns a step at bench_cluster's fleet shape and 1,478 ns a step at k =
// 17, where its 32-slot bucket lived in a 384-byte local-memory frame
// (tools/k4_bench.py, H100 SXM).  This design:
//   - One thread a stream over a ragged layout (int64 offsets [S + 1]), 32
//     streams a block.  The host lays the streams out (lanes [2, n_lanes]:
//     stream or -1, then k) so that each warp holds streams of one
//     instance, longest first, and lanes of a warp end close together.
//   - Jobs through shared memory: a block is two warps over 32 streams.
//     The producer warp stages chunks of kChunk jobs of each stream (ready
//     and dur) into a ring of two stages in dynamic shared memory (~130
//     KB) with cp.async, its lanes on consecutive jobs of one stream (one
//     instruction moves 256 contiguous bytes), and stores each chunk's ends
//     coalesced once the consumer is done with it; the consumer warp runs
//     the recurrence on chunk c while the producer empties chunk c - 1's
//     stage and fills it with chunk c + 1 (one named barrier a chunk).
//     The ends overwrite their ready times in the stage.  A lane's row is
//     kChunk + 1 doubles, so the step's reads (lane i at job u) fall in
//     distinct banks.  With one warp doing both, the copies and stores
//     cost a fifth of the time at 32 busy streams a warp.
//   - A shorter step: one register instance for every k = 1 .. 32 (none
//     pays for slots it does not have), the k free times kept sorted in
//     registers.  The popped value is w[0]; e goes in with one compare a
//     slot, each independent of the others, and two selects a slot (one
//     compare-select deep; the argmin tree was log2 k deep, plus a select a
//     slot to write back; with one busy lane on jobs in shared memory the
//     tree took 1.8x as long at k = 17).  The k initial free times are
//     sorted once, by insertion.  Every index is a constant after
//     unrolling: no local memory, no spills.  A k above 32 takes a generic
//     instance whose sorted row lives in its row of the state output.
//   - Every wide group of a fleet_fifo_finish call goes in one launch, so
//     their chains overlap; the instance switch is warp-uniform.
// What binds it now is the step's issue: k compares, 2k selects and the
// register moves of the shift (SASS at k = 17: 17 DSETP and 43.5 FSEL a
// step, 67 instructions a step in a bare step loop, 87 in the kernel's,
// which moves more registers).  On the H100 a step at k = 17 takes 53.8
// ns at 8 streams a launch (8 x 150,000 jobs), against 52.5 ns with one
// busy lane on a chunk already in shared memory; bench_cluster's fleet
// shape (32 streams of unequal lengths a block, k <= 16) runs 74.3 ns a
// step, two thirds of its floor (tools/k4_bench.py).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the first CUDA error (of the shared-memory attribute or launch).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;          // streams a block: one warp's lanes
constexpr int kChunk = 128;         // jobs of a stream in one stage
constexpr int kPitch = kChunk + 1;  // doubles a lane's row in a stage
constexpr int kStages = 2;          // chunk c, and c + 1 in flight
constexpr int kMaxReg = 32;         // largest k held in registers
constexpr int kStageDoubles = 2 * kLanes * kPitch;  // ready rows, dur rows
// the stages, then the warp's stream table (start and length a lane)
constexpr int kSmemBytes =
    sizeof(double) * kStages * kStageDoubles + 2 * kLanes * sizeof(int64_t);

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

struct Lane {
  int64_t s;  // stream, or -1
  int k;
  int64_t lo, n;  // the stream's first job and its length
};

__device__ __forceinline__ Lane lane_of(const Args& a) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  Lane l{a.lanes[g], a.lanes[a.n_lanes + g], 0, 0};
  if (l.s >= 0) {
    l.lo = a.offsets[l.s];
    l.n = a.offsets[l.s + 1] - l.lo;
  }
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(smem)),
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

// k = K free times in registers, ascending.
template <int K>
struct RegRow {
  double w[K];

  __device__ __forceinline__ void bind(double*, int) {}

  // Sorted by insertion: each value goes in, the largest (+inf at first)
  // drops out.
  __device__ __forceinline__ void init(const double* f0) {
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = CUDART_INF;
#pragma unroll 1
    for (int i = 0; i < K; ++i) {
      const double x = f0[i];
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        const double below = w[j > 0 ? j - 1 : 0];
        const bool keep = w[j] < x;
        const bool at = j == 0 || below < x;
        w[j] = keep ? w[j] : (at ? x : below);
      }
    }
  }

  __device__ __forceinline__ double front() const { return w[0]; }

  // Pop w[0], insert e: slot j takes w[j + 1] where that is below e, e at
  // the first slot where it is not, and keeps w[j] past it.  Each compare
  // w[j + 1] < e is independent of the others, and used by slots j, j + 1.
  // The row is sorted, so w[j + 1] < e implies w[j] < e; selecting on
  // w[j + 1] < e first lets ptxas keep each compare for both slots (one
  // DSETP a slot; the other order made it compute each twice).
  __device__ __forceinline__ void replace_front(double e) {
    bool lt = true;  // w[j] < e, with the popped slot 0 below everything
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const double above = w[j + 1 < K ? j + 1 : j];
      const bool lt_next = j + 1 < K && above < e;
      const double t = lt_next ? above : e;
      w[j] = lt ? t : w[j];
      lt = lt_next;
    }
  }

  __device__ __forceinline__ void store(double* st, int64_t kmax) const {
#pragma unroll
    for (int j = 0; j < K; ++j) st[j] = w[j];
    for (int64_t j = K; j < kmax; ++j) st[j] = CUDART_INF;
  }
};

// Any k: the sorted row is the stream's row of the state output.
struct MemRow {
  double* w;
  int k;

  __device__ __forceinline__ void bind(double* row, int k_) {
    w = row;
    k = k_;
  }

  __device__ void init(const double* f0) {
    for (int i = 0; i < k; ++i) {
      const double x = f0[i];
      int j = i;
      for (; j > 0 && x < w[j - 1]; --j) w[j] = w[j - 1];
      w[j] = x;
    }
  }

  __device__ __forceinline__ double front() const { return w[0]; }

  __device__ void replace_front(double e) {
    int j = 1;
    for (; j < k && w[j] < e; ++j) w[j - 1] = w[j];
    w[j - 1] = e;
  }

  __device__ void store(double*, int64_t kmax) const {
    for (int64_t j = k; j < kmax; ++j) w[j] = CUDART_INF;
  }
};

// The recurrence over `todo` jobs of one chunk in shared memory; each end
// overwrites its ready time.  The next job is read a step ahead (at the
// chunk's end that is the row's pad slot, never used).
template <class Row>
__device__ __forceinline__ void steps(Row& w, double* __restrict__ r,
                                      const double* __restrict__ d,
                                      int todo) {
  double x = r[0], y = d[0];
#pragma unroll 4
  for (int u = 0; u < todo; ++u) {
    const double x_next = r[u + 1], y_next = d[u + 1];
    const double f = w.front();
    const double e = __dadd_rn(x > f ? x : f, y);
    w.replace_front(e);
    r[u] = e;
    x = x_next;
    y = y_next;
  }
}

// A chunk that is whole for every lane with jobs in it runs the loop with
// its trip count known to ptxas (85 -> 65 ns a step at k = 17 on the H100,
// tools/k4_bench.py).  Otherwise the warp runs the general loop once, each
// lane to its own count: lanes taking both loops would run one after the
// other.
template <class Row>
__device__ __forceinline__ void steps_chunk(Row& w, double* r,
                                            const double* d, int todo) {
  if (__all_sync(__activemask(), todo == kChunk || todo == 0)) {
    if (todo) steps(w, r, d, kChunk);
  } else {
    steps(w, r, d, todo);
  }
}

// Chunk c of every stream of the block into stage `st`: for each stream in
// turn (its start and length from the block's table in shared memory), the
// producer's 32 lanes copy 32 consecutive jobs an instruction.
__device__ __forceinline__ void load_chunk(const Args& a, const int64_t* t_lo,
                                           const int64_t* t_n, int64_t c,
                                           double* st) {
  const int lane = threadIdx.x % kLanes;
  const int64_t base = c * kChunk;
#pragma unroll 4
  for (int i = 0; i < kLanes; ++i) {
    const int64_t left = t_n[i] - base;
    if (left <= 0) continue;  // uniform: every lane reads the same entry
    const int64_t lo = t_lo[i] + base;
    double* r = st + i * kPitch;
    double* d = r + kLanes * kPitch;
#pragma unroll
    for (int h = 0; h < kChunk; h += kLanes) {
      const int u = h + lane;
      if (u < left) {
        cp_async_8(r + u, a.ready + lo + u);
        cp_async_8(d + u, a.dur + lo + u);
      }
    }
  }
}

// The ends of chunk c, from stage `st`, coalesced as the loads were.
__device__ __forceinline__ void store_chunk(const Args& a,
                                            const int64_t* t_lo,
                                            const int64_t* t_n, int64_t c,
                                            const double* st) {
  const int lane = threadIdx.x % kLanes;
  const int64_t base = c * kChunk;
#pragma unroll 4
  for (int i = 0; i < kLanes; ++i) {
    const int64_t left = t_n[i] - base;
    if (left <= 0) continue;
    const int64_t lo = t_lo[i] + base;
    const double* r = st + i * kPitch;
#pragma unroll
    for (int h = 0; h < kChunk; h += kLanes) {
      const int u = h + lane;
      if (u < left) a.ends[lo + u] = r[u];
    }
  }
}

// The two warps of a block meet here once a chunk (barrier 1, 64 threads).
__device__ __forceinline__ void chunk_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(2 * kLanes) : "memory");
}

// What both warps of a block know: the stream table, the chunk count, and
// for the consumer its lane and the warp's instance.
struct Block {
  Lane l;
  int key;
  int64_t chunks;
  double* smem;
  const int64_t* t_lo;
  const int64_t* t_n;
};

__device__ __forceinline__ Block setup(const Args& a) {
  extern __shared__ __align__(16) double smem[];
  int64_t* t_lo = reinterpret_cast<int64_t*>(smem + kStages * kStageDoubles);
  int64_t* t_n = t_lo + kLanes;
  const int lane = threadIdx.x % kLanes;
  Block b{Lane{-1, 0, 0, 0}, 0, 0, smem, t_lo, t_n};
  if (threadIdx.x < kLanes) {
    b.l = lane_of(a);
    // every lane of a warp carries one instance's k (the host's layout)
    b.key = __shfl_sync(0xffffffffu, b.l.k, 0);
    t_lo[lane] = b.l.lo;
    t_n[lane] = b.l.n;
  }
  chunk_barrier();
  long long n_max = t_n[lane];
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const long long x = __shfl_xor_sync(0xffffffffu, n_max, o);
    n_max = x > n_max ? x : n_max;
  }
  b.chunks = (n_max + kChunk - 1) / kChunk;
  return b;
}

// The producer warp: chunk c + 1 in while the consumer runs chunk c, after
// chunk c - 1's ends (same stage) are out.
static_assert(kStages == 2, "the producer refills the stage chunk c - 1 left");

__device__ __forceinline__ double* stage(const Block& b, int64_t c) {
  return b.smem + static_cast<int>(c % kStages) * kStageDoubles;
}

__device__ void produce(const Args& a, const Block& b) {
  if (b.chunks > 0) load_chunk(a, b.t_lo, b.t_n, 0, b.smem);
  cp_async_commit();
  cp_async_wait<0>();
  for (int64_t c = 0; c < b.chunks; ++c) {
    chunk_barrier();  // chunk c is in; chunk c - 1 is done
    double* prev = stage(b, c + 1);  // chunk c - 1's, and c + 1's next
    if (c > 0) store_chunk(a, b.t_lo, b.t_n, c - 1, prev);
    __syncwarp();  // every lane's reads of the stage before it refills
    if (c + 1 < b.chunks) load_chunk(a, b.t_lo, b.t_n, c + 1, prev);
    cp_async_commit();
    cp_async_wait<0>();
  }
  chunk_barrier();  // the last chunk is done
  if (b.chunks > 0)
    store_chunk(a, b.t_lo, b.t_n, b.chunks - 1, stage(b, b.chunks - 1));
}

// The consumer warp: the recurrence of its 32 streams, a chunk at a time
// from the stage the producer filled; each end overwrites its ready time.
template <class Row>
__device__ void consume(const Args& a, const Block& b) {
  const Lane& l = b.l;
  Row w;
  if (l.s >= 0) {
    w.bind(a.state + l.s * a.kmax, l.k);
    w.init(a.free0 + l.s * a.kmax);
  }
  const int lane = threadIdx.x;
  for (int64_t c = 0; c < b.chunks; ++c) {
    chunk_barrier();
    double* r = stage(b, c) + lane * kPitch;
    const int64_t left = l.n - c * kChunk;
    const int todo =
        left <= 0 ? 0 : (left < kChunk ? static_cast<int>(left) : kChunk);
    steps_chunk(w, r, r + kLanes * kPitch, todo);
  }
  chunk_barrier();
  if (l.s >= 0) w.store(a.state + l.s * a.kmax, a.kmax);
}

// The consumer's instance: K if K == key, else the next; past kMaxReg,
// generic.
template <int K>
__device__ __forceinline__ void dispatch(const Args& a, const Block& b) {
  if constexpr (K > kMaxReg) {
    consume<MemRow>(a, b);
  } else {
    if (b.key == K)
      consume<RegRow<K>>(a, b);
    else
      dispatch<K + 1>(a, b);
  }
}

// Two warps a block: warp 0 runs the recurrence of the block's 32 streams,
// warp 1 copies their jobs in and their ends out.  One block an SM at
// least: ptxas may give a thread all the registers the widest instance
// needs.
__global__ void __launch_bounds__(2 * kLanes, 1)
    fleet_fifo_kernel(const Args a) {
  const Block b = setup(a);
  if (threadIdx.x >= kLanes)
    produce(a, b);
  else
    dispatch<1>(a, b);
}

}  // namespace

extern "C" {

// ready, dur [total] f64; offsets [S + 1] int64; lanes [2, n_lanes] int32
// (n_lanes a multiple of 32; the k of every lane of a warp is one k <= 32,
// or any k > 32); free0, state [S, kmax] f64; ends [total] f64.
// Contiguous, on `device`.
int repro_fleet_fifo(const void* ready, const void* dur, const void* offsets,
                     const void* lanes, const void* free0, void* ends,
                     void* state, int64_t n_lanes, int64_t kmax,
                     int64_t device, void* stream) {
  if (n_lanes <= 0 || n_lanes % kLanes != 0 || kmax <= 0 ||
      n_lanes / kLanes >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(static_cast<int>(device));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fleet_fifo_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
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
  fleet_fifo_kernel<<<static_cast<unsigned>(n_lanes / kLanes), 2 * kLanes,
                      kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_fleet_fifo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
