// K5 and K6: GroupNorm forward and backward of every U-Net and classifier
// norm (models/layers.py:group_norm), for Hopper.
//
// K5 replaces the Pallas TPU kernel `group_norm_pallas` of
// attic/pallas_norm.py (and the XLA `_group_norm_ref` of
// maze_image_processing_pipeline_tpu/models/layers.py). For x of shape
// (B, C, *spatial) with HW spatial elements, G groups of Cg = C / G
// consecutive channels and n = Cg * HW elements a group:
//
//   mean[b, g] = sum(x) / n,  var = max(sum(x*x) / n - mean^2, 0)  (float32)
//   rstd[b, g] = 1 / sqrt(var + eps)
//   y = (x - mean[b, g(c)]) * (rstd[b, g(c)] * w[c]) + bias[c]
//
// computed in float32 and stored in x's dtype (float32, bfloat16, float16),
// the formula and rounding steps of the plain version. mean and rstd stay
// in a (2, B*G) float32 buffer for the backward.
//
// K6 replaces `group_norm_bwd_pallas` (attic/pallas_norm.py), the VJP
// (x, ct, w) -> (dx, dw, dbias), with the forward's saved mean and rstd
// (the Pallas kernel recomputes them from sums of x and x*x). Per (b, c),
// in float32:
//
//   Sc[b, c] = sum(ct),  Scx[b, c] = sum(ct * (x - mean[b, g(c)]))
//   dw_row[b, c] = rstd * Scx,  dbias_row[b, c] = Sc
//   S1[b, g] = sum_{c in g} w[c] * Sc,  S2[b, g] = sum_{c in g} w[c] * dw_row
//   dx = (rstd * w[c]) * ct + (-rstd^2 * S2 / n) * (x - mean) + (-rstd * S1 / n)
//   dw[c] = sum_b dw_row[b, c],  dbias[c] = sum_b dbias_row[b, c]
//
// dx in x's dtype, dw and dbias in float32. This is the Pallas kernel's
// function (its Scx - mean*Sc and b*x + d, expanded); the sums are taken
// about the mean, so no large terms cancel when |mean| >> std.
//
// Layouts: x is NCHW-contiguous (any number of spatial axes) or, 4-D,
// channels_last (NHWC in memory), as cuDNN returns convolution outputs for a
// channels_last input; y, ct and dx have the layout of x. The wrappers raise
// on any other layout (the backward wrapper copies ct into x's layout).
//
// Bound: device-memory bandwidth. K5 reads x once and writes y once:
// 2 * numel * itemsize bytes, 0.641 ms at (16, 32, 1024, 1024) bf16 at
// 3.35 TB/s. K6 reads x and ct once and writes dx once: 3 * numel *
// itemsize, 0.120 ms at (8, 32, 512, 512) bf16.
//
// Design: one cooperative launch a call, each input read once from device
// memory wherever a normalisation unit fits in the card's shared memory.
// * A unit is what one statistic covers: in NCHW one (b, g) group, the
//   contiguous run of Cg*HW elements; in channels_last one image b, its
//   HW*C elements, so that a block reads whole pixels (every channel of
//   them: no sector is fetched for one group and again for the next) and
//   one pass yields all G groups' partials. A unit is cut into `splits`
//   contiguous shares of `vps` vectors (V elements, 16 B where the shape
//   and alignment allow), one block a share.
// * The grid is persistent and co-resident (cudaLaunchCooperativeKernel,
//   at most the occupancy times the SMs; 256 threads and half an SM's
//   shared memory a block, two blocks an SM). Units go in waves of
//   `units_per_wave`; block i takes share i % splits of units
//   i / splits, i / splits + units_per_wave, ...: all blocks of a unit run
//   it in the same wave, so a barrier waits only on co-resident blocks
//   that reach it without waiting on a later one.
// * A block stages its share's first `stage_vectors` vectors (x, and ct
//   for K6) with cp.async in four commit groups, reads the rest of the
//   share (if any) from device memory meanwhile, and reduces its share
//   (pass 1) a commit group at a time as the copies land. Each thread
//   stages, reads and writes its own slots (K6 NCHW: each warp its own
//   pieces), so no block barrier orders them. It publishes its partials
//   and arrives on the unit's barrier (an integer counter). Once every
//   share has arrived, every block of the unit sums the unit's partials in
//   split order itself (the same sums in the same order in each:
//   deterministic, and no second round trip through device memory) and
//   writes y (K5) or dx (K6) of its share (pass 2): the staged part from
//   shared memory, the rest read again from device memory. A slot, once
//   written, is restaged with the block's next unit's vector, so the next
//   unit's reads overlap this unit's writes. Where a unit fits in the
//   grid's shared memory (the plan in models/layers.py:norm_plan decides),
//   nothing is read twice.
// * The partials: K5 per group sum(x) and sum(x*x); K6 per group the
//   share's parts of S1 and S2 (all that the dx coefficients need), and
//   per channel sum(ct) and sum(ct * (x - mean)) for the dw/dbias rows,
//   which the share owning the channel (channel c: share c % splits) sums
//   over the splits while the other shares arrive at its next barrier.
//   Share 0 stores K5's mean and rstd.
// * No division per element: in NCHW a K5 vector's channel is a
//   multiply-high by a constant (FastDiv), a K6 piece lies in one channel;
//   in channels_last a lane's stride is a multiple of C/V vectors, so each
//   lane always sees the same V channels and keeps their constants in
//   registers. A thread runs one lane, or, where a pixel has more than
//   kThreads vectors (any C: C > 2048 in 16-bit, odd C > 256), its lanes
//   one after another, each lane's channel sums in a table of 2*C floats.
// * One device operation a call: the counters live in a buffer the
//   wrapper keeps per (device, stream), zeroed once when made; the last
//   block to leave a unit's barrier resets its counter, and the K6 share
//   whose rows complete the call's B*C sums them over b (in b order) into
//   dw and dbias and resets its own counter.
//
// The entry points return the first non-zero CUDA error code of their
// set-up and launch (0 = launched); an argument they cannot take is
// cudaErrorInvalidValue.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mutex>
#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;
// Shared scratch before the staged vectors, in floats: the table of at
// least kTable floats (the channels_last reduction, kThreads rows of up to
// 8 channels, or with more than kThreads vectors a pixel two sums of each
// channel; the unit's per-group sums; K6 NCHW's pieces: their sums in the
// first half, their list in the second), then the block sum's warps and a
// flag. kScratchBytes is the scratch at the least table.
constexpr int kTable = kThreads * 8;
constexpr int kScratchBytes = (kTable + 32) * 4;
constexpr int kMaxBlockChannels = 64;       // K6 NCHW: channel planes a share may touch
constexpr int kMaxPieces = 128;             // K6 NCHW: pieces a share is cut into
constexpr int kMaxDevices = 64;
constexpr int kChunk = 4;  // commit groups a unit's staging is cut into
// What a launch does (the kernels' Mode): the whole norm; the sharded
// norm's partials launch (pass 1 and the unit sums, no pass 2); its apply
// launch (pass 2 alone, from statistics or coefficients it is given).
constexpr int kWhole = 0;
constexpr int kPartials = 1;
constexpr int kApply = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// n / d for 0 <= n < 2^31 by a multiply-high (the method of CUTLASS's
// FastDivmod); made on the host once a launch.
struct FastDiv {
  int d;
  unsigned mul, shr;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), mul) >> shr);
  }
};

FastDiv make_fastdiv(int d) {
  FastDiv f{d, 0u, 0u};
  if (d != 1) {
    unsigned l = 0;
    while ((1u << l) < static_cast<unsigned>(d)) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + static_cast<unsigned>(d) - 1) / static_cast<unsigned>(d));
    f.shr = p - 32;
  }
  return f;
}

struct Params {
  const void* x;
  const void* ct;         // K6
  const float* w;
  const float* bias;      // K5
  const float* stats_in;  // K6, and the apply launches: the (2, B*G) mean and rstd
  const float* coef;      // K6 apply: the (2, B*G) dx coefficients
  void* out;              // y or dx
  float* stats;           // K5: (2, B*G) mean and rstd; K5 partials: sum(x) and sum(x*x)
  float* part;            // (units, splits, slots) partials
  float* rows;            // K6 and its partials: (2, B*C) dw and dbias rows
  float* dwb;             // K6: (2, C) dw and dbias
  int* counters;          // [0]: K6's finished units; [1 + unit]: the unit's barrier
  int B, C, G;
  int units, unit_vectors, splits, vps, stage_vectors, units_per_wave, slots, piece;
  int table;              // floats of the shared table (table_floats)
  float n, eps;
  FastDiv plane;          // NCHW: vectors a channel plane
};

// Sum of a float over the block in a fixed order (shuffle tree in each
// warp, then the warps in order); the same value in every thread.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  __syncthreads();  // scratch may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// One vector from device memory into shared memory, asynchronously where
// cp.async takes its size (4, 8, 16 B); a 2-byte vector is copied at once.
template <int Bytes>
__device__ __forceinline__ void stage_one(void* dst, const void* src) {
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem(dst)), "l"(src) : "memory");
  } else if constexpr (Bytes == 8 || Bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem(dst)), "l"(src), "n"(Bytes) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Runs f(c) for the kChunk commit groups of a unit's staging in order,
// each once this thread's copies of it have landed.
template <typename F>
__device__ __forceinline__ void by_chunk(F&& f) {
  static_assert(kChunk == 4, "by_chunk waits on four groups");
  wait_group<3>();
  f(0);
  wait_group<2>();
  f(1);
  wait_group<1>();
  f(2);
  wait_group<0>();
  f(3);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Asks L2 for the bytes [p, p + n) of device memory, in kWarps pieces (a
// range not 16-B aligned is skipped): in NCHW a block's next unit, fetched
// while the block waits at a barrier, so that restaging it reads L2 (with
// 40-90 shares a unit at the path's shapes, its barriers leave the memory
// idle while the last shares arrive).
__device__ __forceinline__ void prefetch_l2(const void* p, size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (((a | n) & 15) != 0) return;
  const size_t piece = round16((n + kWarps - 1) / kWarps);
  const size_t off = piece * (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && off < n) {
    const unsigned bytes = static_cast<unsigned>(n - off < piece ? n - off : piece);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a + off), "r"(bytes) : "memory");
  }
}

// The unit barrier, in two halves. Once the block's partials are written,
// thread 0 arrives on the unit's counter...
__device__ __forceinline__ void unit_arrive(int* cnt) {
  __threadfence();  // every writer's partials, before the count
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(cnt, 1);
}

// ... and later waits until every share has arrived, then leaves; the last
// to leave resets the counter for the next call.
__device__ __forceinline__ void unit_wait(int* cnt, int splits) {
  if (threadIdx.x == 0) {
    while (ld_acquire(cnt) < splits) __nanosleep(32);
    __threadfence();
    if (atomicAdd(cnt, 1) == 2 * splits - 1) atomicExch(cnt, 0);
  }
  __syncthreads();
}

// out[q] = the sum over s < S of part[q * S + s], for q < Q: warp w takes
// q = w, w + kWarps, ..., lane l the splits l, l + 32, ... in order, then
// the warp's shuffle tree. Every block of a unit computes the same sums in
// the same order.
__device__ __forceinline__ void split_sums(const float* part, int S, int Q, float* out) {
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < Q; q += kWarps) {
    float t = 0.f;
#pragma unroll 4
    for (int s = lane; s < S; s += 32) t += __ldcg(&part[static_cast<long long>(q) * S + s]);
    t = warp_sum(t);
    if (lane == 0) out[q] = t;
  }
  __syncthreads();
}

// channels_last: the per-thread sums acc[V] (thread t < active keeps
// channels c0 .. c0 + V - 1 in row t / P) summed over the rows in order,
// per channel, into table[0 .. C).
template <int V>
__device__ __forceinline__ void channel_sums(const float (&acc)[V], float* table, int C, int P, int active,
                                             int c0) {
  const int tid = threadIdx.x;
  __syncthreads();  // the table may still be read
  if (tid < active) {
#pragma unroll
    for (int e = 0; e < V; ++e) table[(tid / P) * C + c0 + e] = acc[e];
  }
  __syncthreads();
  const int rows = active / P;
  for (int c = tid; c < C; c += kThreads) {
    float t = 0.f;
    for (int r = 0; r < rows; ++r) t += table[r * C + c];
    table[c] = t;  // row 0 of column c: only this thread reads it
  }
  __syncthreads();
}

// f(g, t) in lane 0 of warp g % kWarps, t the sum over k < Cg of
// term(g * Cg + k): lane l the terms l, l + 32, ... in order, then the
// warp's shuffle tree.
template <typename Term, typename F>
__device__ __forceinline__ void group_sums(int G, int Cg, Term&& term, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += kWarps) {
    float t = 0.f;
    for (int k = lane; k < Cg; k += 32) t += term(g * Cg + k);
    t = warp_sum(t);
    if (lane == 0) f(g, t);
  }
}

// A block's share [r0, r1) of a unit, its first s1 - r0 vectors staged.
// Strided ownership (K5, K6 channels_last): lane u < A takes vectors
// r0 + u + k * A; the staged ones (slot u + k * A) go in kChunk commit
// groups of kc values of k each. Thread t runs lanes t, t + kThreads, ...
// (one lane unless a pixel has more than kThreads vectors), and the same
// thread reads, writes and restages a lane's slots, so no block barrier
// orders them.
struct Share {
  int r0, r1, s1, A, kc;
  __device__ Share(int split, const Params& p, int lanes) : A(lanes) {
    r0 = split * p.vps;
    r1 = min(p.unit_vectors, r0 + p.vps);
    s1 = min(r1, r0 + p.stage_vectors);
    const int nk = (s1 - r0 + A - 1) / A;
    kc = (nk + kChunk - 1) / kChunk;
  }
  // f(slot) for this thread's staged slots of chunk c.
  template <typename F>
  __device__ __forceinline__ void slots(int c, F&& f) const {
    for (int u = threadIdx.x; u < A; u += kThreads) {
      for (int j = u + c * kc * A, k = 0; k < kc && j < s1 - r0; ++k, j += A) f(j);
    }
  }
  // f(v) for this thread's streamed vectors (past the staged part).
  template <typename F>
  __device__ __forceinline__ void streamed(F&& f) const {
    if (static_cast<int>(threadIdx.x) >= A) return;
    lane_streamed(threadIdx.x, f);
  }
  // f(slot) for lane u's staged slots, all chunks.
  template <typename F>
  __device__ __forceinline__ void lane_slots(int u, F&& f) const {
    for (int j = u; j < s1 - r0; j += A) f(j);
  }
  // f(v) for lane u's streamed vectors.
  template <typename F>
  __device__ __forceinline__ void lane_streamed(int u, F&& f) const {
    const int first = r0 + u + max(0, (s1 - r0 - u + A - 1) / A) * A;
#pragma unroll 4
    for (int v = first; v < r1; v += A) f(v);
  }
};

// channels_last lanes: the vectors of a pixel (P) times as many pixels as
// fit kThreads, or P lanes where a pixel has more than kThreads vectors.
__host__ __device__ __forceinline__ int cl_lanes(int P) { return P <= kThreads ? (kThreads / P) * P : P; }

// K6 NCHW: the share's channel planes cut into pieces of at most p.piece
// vectors, listed once a launch in shared memory: piece g's first vector,
// end and plane at tab[g], tab[kMaxPieces + g], tab[2 * kMaxPieces + g];
// the count at tab[3 * kMaxPieces], then each plane's first piece and the
// end. Warp w owns pieces w, w + kWarps, ... (lane l their vectors
// pa + l + 32 i), in kChunk commit groups of its pieces in order.
struct Pieces {
  int r0, s1, n, mine;
  const int* tab;
  __device__ void build(int split, const Params& p, int* t) {
    r0 = split * p.vps;
    const int r1 = min(p.unit_vectors, r0 + p.vps);
    s1 = min(r1, r0 + p.stage_vectors);
    tab = t;
    if (threadIdx.x == 0) {
      const int Q = p.plane.d;
      int g = 0;
      for (int k = p.plane.div(r0); k <= p.plane.div(r1 - 1); ++k) {
        const int a = max(r0, k * Q), e = min(r1, (k + 1) * Q);
        for (int pa = a; pa < e; pa += p.piece, ++g) {
          t[g] = pa;
          t[kMaxPieces + g] = min(e, pa + p.piece);
          t[2 * kMaxPieces + g] = k;
        }
      }
      t[3 * kMaxPieces] = g;
      // The first piece of each of the share's channel planes, and the end.
      const int k_lo = t[2 * kMaxPieces];
      for (int i = 0; i < g; ++i) {
        const int k = t[2 * kMaxPieces + i];
        if (i == 0 || k != t[2 * kMaxPieces + i - 1]) t[3 * kMaxPieces + 1 + k - k_lo] = i;
      }
      t[3 * kMaxPieces + 1 + t[2 * kMaxPieces + g - 1] - k_lo + 1] = g;
    }
    __syncthreads();
    n = t[3 * kMaxPieces];
    const int warp = threadIdx.x >> 5;
    mine = n > warp ? (n - warp + kWarps - 1) / kWarps : 0;
  }
  // f(g, pa, pe, plane) for this warp's pieces of chunk c.
  template <typename F>
  __device__ __forceinline__ void chunk(int c, F&& f) const {
    const int warp = threadIdx.x >> 5;
    const int i1 = ((c + 1) * mine + kChunk - 1) / kChunk;
    for (int i = (c * mine + kChunk - 1) / kChunk; i < i1; ++i) {
      const int g = warp + i * kWarps;
      f(g, tab[g], tab[kMaxPieces + g], tab[2 * kMaxPieces + g]);
    }
  }
};

// ---------------------------------------------------------------- K5 ----

// Mode kPartials writes each unit's two sums (not its mean and rstd) to
// p.stats and no y; kApply writes y from the mean and rstd in p.stats_in.
// Both run with nothing staged (each reads x once).
template <typename T, int V, bool CL, int Mode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gn_fwd_kernel(const Params p) {
  using Vt = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char shm[];
  float* table = reinterpret_cast<float*>(shm);
  float* red = table + p.table;
  Vt* stage = reinterpret_cast<Vt*>(red + 32);
  const Vt* x = static_cast<const Vt*>(p.x);
  Vt* y = static_cast<Vt*>(p.out);
  const int tid = threadIdx.x;
  const int C = p.C, G = p.G, Cg = C / G, S = p.splits;
  const int ng = CL ? G : 1;
  const long long nb = static_cast<long long>(p.B) * G;
  const int split = blockIdx.x % S;
  // channels_last: lane u takes vectors r0 + u + k * lanes, all of the
  // channels c0 .. c0 + V - 1 (P = C / V vectors a pixel); a thread runs
  // one lane (c0 in registers) unless P > kThreads (`wide`: each lane in
  // turn, its channel sums through the table).
  const int P = CL ? C / V : 1;
  const Share sh(split, p, CL ? cl_lanes(P) : kThreads);
  const bool wide = CL && P > kThreads;
  const int c0 = CL ? ((sh.r0 + tid) % P) * V : 0;

  int unit = blockIdx.x / S;
  if (unit < p.units) {
    const Vt* src = x + static_cast<long long>(unit) * p.unit_vectors + sh.r0;
    for (int c = 0; c < kChunk; ++c) {
      sh.slots(c, [&](int j) { stage_one<sizeof(Vt)>(stage + j, src + j); });
      commit_group();
    }
  }
  for (; unit < p.units; unit += p.units_per_wave) {
    const Vt* xu = x + static_cast<long long>(unit) * p.unit_vectors;
    Vt* yu = y + static_cast<long long>(unit) * p.unit_vectors;
    float* part = p.part + static_cast<long long>(unit) * S * p.slots;  // [2 * ng][S]

    if constexpr (Mode != kApply) {
      // Pass 1: the streamed vectors while the copies land, then the staged
      // ones, a commit group at a time.
      float a1[CL ? V : 1], a2[CL ? V : 1];
#pragma unroll
      for (int e = 0; e < (CL ? V : 1); ++e) a1[e] = a2[e] = 0.f;
      auto add = [&](const Vt& v) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float f = to_f(v.v[e]);
          a1[CL ? e : 0] += f;
          a2[CL ? e : 0] = fmaf(f, f, a2[CL ? e : 0]);
        }
      };
      if (!wide) {
        sh.streamed([&](int v) { add(xu[v]); });
        by_chunk([&](int c) { sh.slots(c, [&](int j) { add(stage[j]); }); });
      }

      // The block's partials: NCHW the group's two sums; channels_last each
      // group's, its channels in order.
      if constexpr (CL) {
        if (wide) {
          wait_group<0>();
          __syncthreads();  // the table may still be read
          for (int u = tid; u < sh.A; u += kThreads) {  // each lane's own channels: table[c], table[C + c]
#pragma unroll
            for (int e = 0; e < V; ++e) a1[e] = a2[e] = 0.f;
            sh.lane_streamed(u, [&](int v) { add(xu[v]); });
            sh.lane_slots(u, [&](int j) { add(stage[j]); });
            const int cu = ((sh.r0 + u) % P) * V;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              table[cu + e] = a1[e];
              table[C + cu + e] = a2[e];
            }
          }
          __syncthreads();
          group_sums(G, Cg, [&](int c) { return table[c]; }, [&](int g, float t) { part[g * S + split] = t; });
          group_sums(G, Cg, [&](int c) { return table[C + c]; },
                     [&](int g, float t) { part[(G + g) * S + split] = t; });
        } else {
          channel_sums<V>(a1, table, C, P, sh.A, c0);
          auto from_table = [&](int c) { return table[c]; };
          group_sums(G, Cg, from_table, [&](int g, float t) { part[g * S + split] = t; });
          channel_sums<V>(a2, table, C, P, sh.A, c0);
          group_sums(G, Cg, from_table, [&](int g, float t) { part[(G + g) * S + split] = t; });
        }
      } else {
        const float t1 = block_sum(a1[0], red);
        const float t2 = block_sum(a2[0], red);
        if (tid == 0) {
          part[split] = t1;
          part[S + split] = t2;
        }
      }
      int* cnt = p.counters + 1 + unit;
      unit_arrive(cnt);
      if (!CL && unit + p.units_per_wave < p.units) {  // (channels_last measured slower with it)
        prefetch_l2(xu + static_cast<long long>(p.units_per_wave) * p.unit_vectors + sh.r0,
                    static_cast<size_t>(sh.s1 - sh.r0) * sizeof(Vt));
      }
      unit_wait(cnt, S);

      // Every block: the unit's sums in split order, mean and rstd (share 0
      // stores them; the partials launch stores the sums).
      split_sums(part, S, 2 * ng, table);
      for (int g = tid; g < ng; g += kThreads) {
        if constexpr (Mode == kPartials) {
          if (split == 0) {
            const long long bg = CL ? static_cast<long long>(unit) * G + g : unit;
            p.stats[bg] = table[g];
            p.stats[nb + bg] = table[ng + g];
          }
          continue;
        }
        const float mean = __fdiv_rn(table[g], p.n);
        const float var = fmaxf(__fsub_rn(__fdiv_rn(table[ng + g], p.n), __fmul_rn(mean, mean)), 0.f);
        const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
        table[g] = mean;
        table[ng + g] = rstd;
        if (split == 0) {
          const long long bg = CL ? static_cast<long long>(unit) * G + g : unit;
          p.stats[bg] = mean;
          p.stats[nb + bg] = rstd;
        }
      }
    } else {  // kApply: the given mean and rstd
      for (int g = tid; g < ng; g += kThreads) {
        const long long bg = CL ? static_cast<long long>(unit) * G + g : unit;
        table[g] = __ldg(&p.stats_in[bg]);
        table[ng + g] = __ldg(&p.stats_in[nb + bg]);
      }
    }
    __syncthreads();

    if constexpr (Mode != kPartials) {
      // Pass 2: y = (x - mean) * (rstd * w) + bias; each staged slot, once
      // written, takes the next unit's vector.
      const bool next = unit + p.units_per_wave < p.units;
      const Vt* src = xu + static_cast<long long>(p.units_per_wave) * p.unit_vectors + sh.r0;
      if constexpr (CL) {
        float mean[V], scale[V], shift[V];
        auto consts = [&](int cl) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int c = cl + e;
            mean[e] = table[c / Cg];
            scale[e] = __fmul_rn(table[G + c / Cg], __ldg(&p.w[c]));
            shift[e] = __ldg(&p.bias[c]);
          }
        };
        auto norm = [&](const Vt& v) {
          Vt o;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            o.v[e] = from_f<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_f(v.v[e]), mean[e]), scale[e]), shift[e]));
          }
          return o;
        };
        if (wide) {
          for (int u = tid; u < sh.A; u += kThreads) {
            consts(((sh.r0 + u) % P) * V);
            sh.lane_slots(u, [&](int j) {
              yu[sh.r0 + j] = norm(stage[j]);
              if (next) stage_one<sizeof(Vt)>(stage + j, src + j);
            });
            sh.lane_streamed(u, [&](int v) { yu[v] = norm(xu[v]); });
          }
          commit_group();
        } else {
          consts(c0);
          for (int c = 0; c < kChunk; ++c) {
            sh.slots(c, [&](int j) {
              yu[sh.r0 + j] = norm(stage[j]);
              if (next) stage_one<sizeof(Vt)>(stage + j, src + j);
            });
            commit_group();
          }
          sh.streamed([&](int v) { yu[v] = norm(xu[v]); });
        }
      } else {
        const float mean = table[0], rstd = table[1];
        const int cbase = (unit % G) * Cg;
        auto norm = [&](const Vt& v, int vi) {
          const int c = cbase + p.plane.div(vi);
          const float scale = __fmul_rn(rstd, __ldg(&p.w[c]));
          const float shift = __ldg(&p.bias[c]);
          Vt o;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            o.v[e] = from_f<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_f(v.v[e]), mean), scale), shift));
          }
          return o;
        };
        for (int c = 0; c < kChunk; ++c) {
          sh.slots(c, [&](int j) {
            yu[sh.r0 + j] = norm(stage[j], sh.r0 + j);
            if (next) stage_one<sizeof(Vt)>(stage + j, src + j);
          });
          commit_group();
        }
        sh.streamed([&](int v) { yu[v] = norm(xu[v], v); });
      }
    }
    __syncthreads();  // the table is rewritten by the next unit
  }
}

// ---------------------------------------------------------------- K6 ----

// Mode kPartials writes the dw and dbias rows of each (b, c) (the sums
// about p.stats_in's mean) and no dx, nor dw and dbias; kApply writes dx
// from the coefficients in p.coef (per (b, g): the factor of x - mean, then
// the term added). Both run with nothing staged.
template <typename T, int V, bool CL, int Mode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gn_bwd_kernel(const Params p) {
  using Vt = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char shm[];
  float* table = reinterpret_cast<float*>(shm);
  float* red = table + p.table;
  int* flag = reinterpret_cast<int*>(red + kWarps);
  const int stage_bytes = static_cast<int>(round16(static_cast<size_t>(p.stage_vectors) * sizeof(Vt)));
  Vt* stage_x = reinterpret_cast<Vt*>(red + 32);
  Vt* stage_c = reinterpret_cast<Vt*>(reinterpret_cast<unsigned char*>(stage_x) + stage_bytes);
  const Vt* x = static_cast<const Vt*>(p.x);
  const Vt* ct = static_cast<const Vt*>(p.ct);
  Vt* dx = static_cast<Vt*>(p.out);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.C, G = p.G, Cg = C / G, S = p.splits;
  const int ng = CL ? G : 1;
  const int cs = CL ? 2 * C : 2 * kMaxBlockChannels;  // a share's per-channel partials
  const long long nb = static_cast<long long>(p.B) * G;
  const long long BC = static_cast<long long>(p.B) * C;
  const int split = blockIdx.x % S;
  const int P = CL ? C / V : 1;
  const Share sh(split, p, CL ? cl_lanes(P) : kThreads);
  const bool wide = CL && P > kThreads;  // as in K5
  const int c0 = CL ? ((sh.r0 + tid) % P) * V : 0;
  const long long step = static_cast<long long>(p.units_per_wave) * p.unit_vectors;
  Pieces pc{};
  if constexpr (!CL) pc.build(split, p, reinterpret_cast<int*>(table + kTable / 2));

  // Stages the share of the unit at xu, cu (channels_last: this thread's
  // slots; NCHW: this warp's pieces), in kChunk commit groups.
  auto stage = [&](const Vt* xu, const Vt* cu) {
    for (int c = 0; c < kChunk; ++c) {
      if constexpr (CL) {
        sh.slots(c, [&](int j) {
          stage_one<sizeof(Vt)>(stage_x + j, xu + sh.r0 + j);
          stage_one<sizeof(Vt)>(stage_c + j, cu + sh.r0 + j);
        });
      } else {
        pc.chunk(c, [&](int, int pa, int pe, int) {
          for (int v = pa + lane; v < min(pe, pc.s1); v += 32) {
            stage_one<sizeof(Vt)>(stage_x + v - pc.r0, xu + v);
            stage_one<sizeof(Vt)>(stage_c + v - pc.r0, cu + v);
          }
        });
      }
      commit_group();
    }
  };

  // The dw/dbias rows of unit u for the channels this share owns (channel
  // c of the unit's channels: share c % S, a warp each), the per-channel
  // partials summed over the splits; the share whose rows complete the
  // call's B*C sums them over b, in b order, into dwb.
  auto rows = [&](int u) {
    const float* chan = p.part + static_cast<long long>(u) * S * p.slots + 2 * ng * S;
    const int nchan = CL ? C : Cg;
    const long long row0 = CL ? static_cast<long long>(u) * C
                              : static_cast<long long>(u / G) * C + static_cast<long long>(u % G) * Cg;
    // Channel split + o * S, o = 0, 1, ...: a group of L lanes each (as
    // many as the splits, at most a warp), lane j its splits j, j + L, ...
    int L = 1;
    while (L < 32 && L < S) L <<= 1;
    const int per_round = kThreads / L;
    const int owned = split < nchan ? (nchan - split + S - 1) / S : 0;
    for (int o0 = 0; o0 < owned; o0 += per_round) {
      const int o = o0 + tid / L, j = tid % L;
      const int c = split + o * S;
      float t1 = 0.f, t2 = 0.f;
      if (o < owned) {
        if constexpr (CL) {
          for (int s = j; s < S; s += L) {
            t1 += __ldcg(&chan[static_cast<long long>(s) * cs + c]);
            t2 += __ldcg(&chan[static_cast<long long>(s) * cs + C + c]);
          }
        } else {  // plane c lies in splits c*Q / vps .. ((c+1)*Q - 1) / vps
          const int Q = p.plane.d;
          const int s_hi = ((c + 1) * Q - 1) / p.vps;
          for (int s = c * Q / p.vps + j; s <= s_hi; s += L) {
            const int kk = c - s * p.vps / Q;
            t1 += __ldcg(&chan[static_cast<long long>(s) * cs + kk]);
            t2 += __ldcg(&chan[static_cast<long long>(s) * cs + kMaxBlockChannels + kk]);
          }
        }
      }
      for (int d = L >> 1; d > 0; d >>= 1) {
        t1 += __shfl_xor_sync(kFull, t1, d);
        t2 += __shfl_xor_sync(kFull, t2, d);
      }
      if (o < owned && j == 0) {
        const long long bg = CL ? static_cast<long long>(u) * G + c / Cg : u;
        p.rows[row0 + c] = __fmul_rn(__ldg(&p.stats_in[nb + bg]), t2);
        p.rows[BC + row0 + c] = t1;
      }
    }
    if (Mode == kPartials || owned == 0) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) *flag = atomicAdd(&p.counters[0], owned) + owned == BC;
    __syncthreads();
    if (*flag) {
      __threadfence();
      for (int c = tid; c < C; c += kThreads) {
        float dw = 0.f, db = 0.f;
        for (int b = 0; b < p.B; ++b) {
          dw += __ldcg(&p.rows[static_cast<long long>(b) * C + c]);
          db += __ldcg(&p.rows[BC + static_cast<long long>(b) * C + c]);
        }
        p.dwb[c] = dw;
        p.dwb[C + c] = db;
      }
      if (tid == 0) atomicExch(&p.counters[0], 0);
    }
  };

  int unit = blockIdx.x / S;
  if (unit < p.units) {
    stage(x + static_cast<long long>(unit) * p.unit_vectors, ct + static_cast<long long>(unit) * p.unit_vectors);
  }
  int owed = -1;  // the unit whose rows this share still owes
  for (; unit < p.units; unit += p.units_per_wave) {
    const long long ubase = static_cast<long long>(unit) * p.unit_vectors;
    const Vt* xu = x + ubase;
    const Vt* cu = ct + ubase;
    Vt* du = dx + ubase;
    float* part = p.part + static_cast<long long>(unit) * S * p.slots;  // [2 * ng][S], then [S][cs]
    float* chan = part + 2 * ng * S + static_cast<long long>(split) * cs;

    if constexpr (Mode != kApply) {
      // Pass 1: per channel, sum(ct) and sum(ct * (x - mean)); per group the
      // share's parts of S1 = sum w * Sc and S2 = sum w * rstd * Scx.
      if constexpr (CL) {
        float mean[V], s[V], sx[V];
        auto start = [&](int cl) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            mean[e] = __ldg(&p.stats_in[static_cast<long long>(unit) * G + (cl + e) / Cg]);
            s[e] = sx[e] = 0.f;
          }
        };
        auto add = [&](const Vt& xv, const Vt& cv) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float c = to_f(cv.v[e]);
            s[e] += c;
            sx[e] = fmaf(c, to_f(xv.v[e]) - mean[e], sx[e]);
          }
        };
        const float* rstd_u = p.stats_in + nb + static_cast<long long>(unit) * G;
        if (wide) {  // each lane's own channels: table[c], table[C + c]
          wait_group<0>();
          __syncthreads();  // the table may still be read
          for (int u = tid; u < sh.A; u += kThreads) {
            const int cl = ((sh.r0 + u) % P) * V;
            start(cl);
            sh.lane_streamed(u, [&](int v) { add(xu[v], cu[v]); });
            sh.lane_slots(u, [&](int j) { add(stage_x[j], stage_c[j]); });
#pragma unroll
            for (int e = 0; e < V; ++e) {
              table[cl + e] = s[e];
              table[C + cl + e] = sx[e];
            }
          }
          __syncthreads();
          for (int c = tid; c < 2 * C; c += kThreads) chan[c] = table[c];
          if constexpr (Mode == kWhole) {
            group_sums(G, Cg, [&](int c) { return __fmul_rn(__ldg(&p.w[c]), table[c]); },
                       [&](int g, float t) { part[g * S + split] = t; });
            group_sums(G, Cg, [&](int c) { return __fmul_rn(__ldg(&p.w[c]), __fmul_rn(__ldg(&rstd_u[c / Cg]), table[C + c])); },
                       [&](int g, float t) { part[(G + g) * S + split] = t; });
          }
        } else {
          start(c0);
          sh.streamed([&](int v) { add(xu[v], cu[v]); });
          by_chunk([&](int c) { sh.slots(c, [&](int j) { add(stage_x[j], stage_c[j]); }); });
          channel_sums<V>(s, table, C, P, sh.A, c0);
          for (int c = tid; c < C; c += kThreads) chan[c] = table[c];
          if constexpr (Mode == kWhole) {
            group_sums(G, Cg, [&](int c) { return __fmul_rn(__ldg(&p.w[c]), table[c]); },
                       [&](int g, float t) { part[g * S + split] = t; });
          }
          channel_sums<V>(sx, table, C, P, sh.A, c0);
          for (int c = tid; c < C; c += kThreads) chan[C + c] = table[c];
          if constexpr (Mode == kWhole) {
            group_sums(G, Cg, [&](int c) { return __fmul_rn(__ldg(&p.w[c]), __fmul_rn(__ldg(&rstd_u[c / Cg]), table[c])); },
                       [&](int g, float t) { part[(G + g) * S + split] = t; });
          }
        }
      } else {
        // Each of this warp's pieces reduced into table[2 * g], then each
        // channel's pieces summed in order.
        const float mean = __ldg(&p.stats_in[unit]);
        auto piece_sums = [&](int g, int pa, int pe, int) {
          float s = 0.f, sx = 0.f;
          for (int v = pa + lane; v < pe; v += 32) {
            const Vt xv = v < pc.s1 ? stage_x[v - pc.r0] : xu[v];
            const Vt cv = v < pc.s1 ? stage_c[v - pc.r0] : cu[v];
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float c = to_f(cv.v[j]);
              s += c;
              sx = fmaf(c, to_f(xv.v[j]) - mean, sx);
            }
          }
          s = warp_sum(s);
          sx = warp_sum(sx);
          if (lane == 0) {
            table[2 * g] = s;
            table[2 * g + 1] = sx;
          }
        };
        by_chunk([&](int c) { pc.chunk(c, piece_sums); });
        __syncthreads();
        const int k_lo = pc.tab[2 * kMaxPieces], nch = pc.tab[2 * kMaxPieces + pc.n - 1] - k_lo + 1;
        for (int kk = tid; kk < nch; kk += kThreads) {
          float t1 = 0.f, t2 = 0.f;
          for (int g = pc.tab[3 * kMaxPieces + 1 + kk]; g < pc.tab[3 * kMaxPieces + 2 + kk]; ++g) {
            t1 += table[2 * g];
            t2 += table[2 * g + 1];
          }
          chan[kk] = t1;
          chan[kMaxBlockChannels + kk] = t2;
          table[2 * kMaxPieces + 2 * kk] = t1;
          table[2 * kMaxPieces + 2 * kk + 1] = t2;
        }
        __syncthreads();
        if (Mode == kWhole && warp == 0) {  // the partials launch leaves S1 and S2 to the wrapper
          const float rstd = __ldg(&p.stats_in[nb + unit]);
          const float* w = p.w + (unit % G) * Cg + k_lo;
          float t1 = 0.f, t2 = 0.f;
          for (int kk = lane; kk < nch; kk += 32) {
            t1 += __fmul_rn(__ldg(&w[kk]), table[2 * kMaxPieces + 2 * kk]);
            t2 += __fmul_rn(__ldg(&w[kk]), __fmul_rn(rstd, table[2 * kMaxPieces + 2 * kk + 1]));
          }
          t1 = warp_sum(t1);
          t2 = warp_sum(t2);
          if (lane == 0) {
            part[split] = t1;
            part[S + split] = t2;
          }
        }
      }
      int* cnt = p.counters + 1 + unit;
      unit_arrive(cnt);
      if (!CL && unit + p.units_per_wave < p.units) {  // (channels_last measured slower with it)
        const size_t bytes = static_cast<size_t>(pc.s1 - pc.r0) * sizeof(Vt);
        prefetch_l2(xu + step + pc.r0, bytes);
        prefetch_l2(cu + step + pc.r0, bytes);
      }
      if (owed >= 0) rows(owed);  // while the other shares arrive
      unit_wait(cnt, S);
      owed = unit;
    }

    if constexpr (Mode == kWhole) {
      // Every block: S1 and S2 in split order, then the dx coefficients.
      split_sums(part, S, 2 * ng, table);
      for (int g = tid; g < ng; g += kThreads) {
        const float rstd = __ldg(&p.stats_in[nb + (CL ? static_cast<long long>(unit) * G + g : unit)]);
        const float s1 = table[g], s2 = table[ng + g];
        table[g] = __fdiv_rn(__fmul_rn(__fmul_rn(-rstd, rstd), s2), p.n);  // times (x - mean)
        table[ng + g] = __fdiv_rn(__fmul_rn(-rstd, s1), p.n);              // added
      }
      __syncthreads();
    } else if constexpr (Mode == kApply) {
      for (int g = tid; g < ng; g += kThreads) {
        const long long bg = CL ? static_cast<long long>(unit) * G + g : unit;
        table[g] = __ldg(&p.coef[bg]);
        table[ng + g] = __ldg(&p.coef[nb + bg]);
      }
      __syncthreads();
    }

    if constexpr (Mode != kPartials) {
      // Pass 2: dx = (rstd * w) * ct + cx * (x - mean) + cd; each staged
      // slot, once written, takes the next unit's vector.
      const bool next = unit + p.units_per_wave < p.units;
      if constexpr (CL) {
        float mean[V], a[V], cx[V], cd[V];
        auto consts = [&](int cl) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int c = cl + e;
            const long long bg = static_cast<long long>(unit) * G + c / Cg;
            mean[e] = __ldg(&p.stats_in[bg]);
            a[e] = __fmul_rn(__ldg(&p.stats_in[nb + bg]), __ldg(&p.w[c]));
            cx[e] = table[c / Cg];
            cd[e] = table[G + c / Cg];
          }
        };
        auto grad = [&](const Vt& xv, const Vt& cv) {
          Vt o;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xc = __fsub_rn(to_f(xv.v[e]), mean[e]);
            o.v[e] = from_f<T>(__fadd_rn(__fadd_rn(__fmul_rn(a[e], to_f(cv.v[e])), __fmul_rn(cx[e], xc)), cd[e]));
          }
          return o;
        };
        auto write = [&](int j) {
          du[sh.r0 + j] = grad(stage_x[j], stage_c[j]);
          if (next) {
            stage_one<sizeof(Vt)>(stage_x + j, xu + step + sh.r0 + j);
            stage_one<sizeof(Vt)>(stage_c + j, cu + step + sh.r0 + j);
          }
        };
        if (wide) {
          for (int u = tid; u < sh.A; u += kThreads) {
            consts(((sh.r0 + u) % P) * V);
            sh.lane_slots(u, write);
            sh.lane_streamed(u, [&](int v) { du[v] = grad(xu[v], cu[v]); });
          }
          commit_group();
        } else {
          consts(c0);
          for (int c = 0; c < kChunk; ++c) {
            sh.slots(c, write);
            commit_group();
          }
          sh.streamed([&](int v) { du[v] = grad(xu[v], cu[v]); });
        }
      } else {
        const float mean = __ldg(&p.stats_in[unit]);
        const float rstd = __ldg(&p.stats_in[nb + unit]);
        const float cx = table[0], cd = table[1];
        const int cbase = (unit % G) * Cg;
        for (int c = 0; c < kChunk; ++c) {
          pc.chunk(c, [&](int, int pa, int pe, int k) {
            const float a = __fmul_rn(rstd, __ldg(&p.w[cbase + k]));
            for (int v = pa + lane; v < pe; v += 32) {
              const bool staged = v < pc.s1;
              const Vt xv = staged ? stage_x[v - pc.r0] : xu[v];
              const Vt cv = staged ? stage_c[v - pc.r0] : cu[v];
              Vt o;
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float xc = __fsub_rn(to_f(xv.v[e]), mean);
                o.v[e] = from_f<T>(__fadd_rn(__fadd_rn(__fmul_rn(a, to_f(cv.v[e])), __fmul_rn(cx, xc)), cd));
              }
              du[v] = o;
              if (staged && next) {
                stage_one<sizeof(Vt)>(stage_x + v - pc.r0, xu + step + v);
                stage_one<sizeof(Vt)>(stage_c + v - pc.r0, cu + step + v);
              }
            }
          });
          commit_group();
        }
      }
    }
    __syncthreads();  // the table is rewritten by the next unit
  }
  if (owed >= 0) rows(owed);
}

// ----------------------------------------------------------- launching ----

struct Info {
  int smem, per_sm, sms;
};

// The kernel's dynamic shared memory (half an SM's, less the per-block
// reserve), its co-resident blocks an SM at that size and the SMs: queried
// once per kernel and device, with the size set on the kernel.
template <typename T, int V, bool CL, bool BWD, int Mode>
int kernel_info(Info* out) {
  static std::mutex mu;
  static Info cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  Info& c = cache[dev];
  if (c.per_sm == 0) {
    int per_sm_smem = 0, reserved = 0, optin = 0, sms = 0;
    e = cudaDeviceGetAttribute(&per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int smem = std::min(per_sm_smem / kBlocksPerSm - reserved, optin) / 16 * 16;
    if (smem <= kScratchBytes) return static_cast<int>(cudaErrorInvalidConfiguration);
    const void* kernel = BWD ? reinterpret_cast<const void*>(gn_bwd_kernel<T, V, CL, Mode>)
                             : reinterpret_cast<const void*>(gn_fwd_kernel<T, V, CL, Mode>);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    c = Info{smem, per_sm, sms};
  }
  *out = c;
  return 0;
}

template <typename T, int V, bool CL, bool BWD, int Mode = kWhole>
int launch(Params& p, cudaStream_t stream) {
  Info in{};
  if (int err = kernel_info<T, V, CL, BWD, Mode>(&in)) return err;
  const long long grid = static_cast<long long>(p.units_per_wave) * p.splits;
  const size_t staged = (BWD ? 2 : 1) * round16(static_cast<size_t>(p.stage_vectors) * sizeof(Vec<T, V>));
  if (grid < 1 || grid > static_cast<long long>(in.per_sm) * in.sms ||
      staged + (p.table + 32) * sizeof(float) > static_cast<size_t>(in.smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = BWD ? reinterpret_cast<const void*>(gn_bwd_kernel<T, V, CL, Mode>)
                           : reinterpret_cast<const void*>(gn_fwd_kernel<T, V, CL, Mode>);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                                                      args, static_cast<size_t>(in.smem), stream));
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<T>, integral_constant<int, V>, bool_constant<CL>) for the
// dtype code (0 float32, 1 bfloat16, 2 float16), vector width (1, 2, 4, 8;
// 8 only for 16-bit types) and layout; an invalid value's error otherwise.
template <typename F>
int dispatch(int dtype, int vec, int channels_last, F&& f) {
  auto by_layout = [&](auto t, auto v) -> int {
    if (channels_last) return f(t, v, std::true_type{});
    return f(t, v, std::false_type{});
  };
  auto by_vec = [&](auto t) -> int {
    using T = typename decltype(t)::type;
    switch (vec) {
      case 1: return by_layout(t, std::integral_constant<int, 1>{});
      case 2: return by_layout(t, std::integral_constant<int, 2>{});
      case 4: return by_layout(t, std::integral_constant<int, 4>{});
      case 8:
        if constexpr (sizeof(T) <= 2) {
          return by_layout(t, std::integral_constant<int, 8>{});
        } else {
          return static_cast<int>(cudaErrorInvalidValue);
        }
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (dtype) {
    case 0: return by_vec(Tag<float>{});
    case 1: return by_vec(Tag<__nv_bfloat16>{});
    case 2: return by_vec(Tag<__half>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of the shared table: kTable, or two sums of each channel where a
// channels_last pixel has more than kThreads vectors, or 2*G group sums
// (channels_last) where they are more.
int table_floats(int C, int G, int channels_last, int vec) {
  int t = kTable;
  if (channels_last) t = std::max(t, std::max(C / vec > kThreads ? 2 * C : 0, 2 * G));
  return (t + 3) / 4 * 4;
}

// Fills the plan's part of p and checks what the kernels take: vec
// dividing HW (NCHW) or C (channels_last), units of fewer than 2^31 vectors, shares
// covering each unit, and (K6 NCHW) a share's channel planes and pieces
// within the table.
bool plan_params(Params& p, int B, int C, int G, long long HW, int channels_last, int vec, int splits, int vps,
                 int stage_vectors, int units_per_wave, int piece, bool backward) {
  if (C <= 0 || G <= 0 || C % G != 0 || vec <= 0 || (channels_last ? C : HW) % vec != 0) return false;
  const long long units = channels_last ? B : static_cast<long long>(B) * G;
  const long long unit_vectors = (channels_last ? C * HW : (C / G) * HW) / vec;
  if (units >= (1LL << 31) || unit_vectors >= (1LL << 31)) return false;
  if (splits < 1 || vps < 1 || stage_vectors < 0 || stage_vectors > vps || units_per_wave < 1) return false;
  if (static_cast<long long>(splits) * vps < unit_vectors || static_cast<long long>(splits - 1) * vps >= unit_vectors)
    return false;
  const long long plane = HW / vec;
  if (backward && !channels_last) {
    if (piece < 1 || (vps + plane - 1) / plane + 1 > kMaxBlockChannels ||
        (vps + piece - 1) / piece + kMaxBlockChannels > kMaxPieces)
      return false;
  }
  p.B = B;
  p.C = C;
  p.G = G;
  p.units = static_cast<int>(units);
  p.unit_vectors = static_cast<int>(unit_vectors);
  p.splits = splits;
  p.vps = vps;
  p.stage_vectors = stage_vectors;
  p.units_per_wave = units_per_wave;
  p.piece = piece;
  // Partials a share: 2 per group of the unit, K6's per-channel ones too.
  p.slots = (channels_last ? 2 * G : 2) + (backward ? (channels_last ? 2 * C : 2 * kMaxBlockChannels) : 0);
  p.table = table_floats(C, G, channels_last, vec);
  p.n = static_cast<float>(static_cast<long long>(C / G) * HW);
  p.plane = make_fastdiv(channels_last ? 1 : static_cast<int>(plane));
  return true;
}

}  // namespace

// The kernels' capacity for a dtype code, vector width and layout: out[0]
// co-resident blocks an SM, out[1] SMs, out[2] the bytes a block may stage
// (its dynamic shared memory less the scratch). Sets the kernels' shared
// memory size on the current device.
extern "C" int group_norm_capacity(int backward, int dtype, int vec, int channels_last, int* out) {
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    Info in{};
    const int err = backward ? kernel_info<T, decltype(v)::value, decltype(cl)::value, true, kWhole>(&in)
                             : kernel_info<T, decltype(v)::value, decltype(cl)::value, false, kWhole>(&in);
    if (err) return err;
    out[0] = in.per_sm;
    out[1] = in.sms;
    out[2] = in.smem - kScratchBytes;
    return 0;
  });
}

// K5. x, y: (B, C, HW) NCHW-contiguous or (B, HW, C) channels_last, dtype 0
// = float32, 1 = bfloat16, 2 = float16; w, bias: (C,) float32; stats: (2,
// B*G) float32 output (mean, rstd); part: (units, slots, splits) float32
// scratch (slots 2 NCHW, 2*G channels_last); counters: (1 + units,) int32,
// zero, left zero. vec: elements per load, dividing HW (NCHW) or C
// (channels_last), with x and y aligned to vec * itemsize. The plan
// (models/layers.py:norm_plan): splits shares of vps vectors a unit, the
// first stage_vectors of each staged, units_per_wave units a wave
// (units_per_wave * splits blocks, all co-resident).
extern "C" int group_norm_launch(const void* x, const void* w, const void* bias, void* y, void* stats, void* part,
                                 void* counters, int B, int C, int G, long long HW, int channels_last, int dtype,
                                 int vec, int splits, int vps, int stage_vectors, int units_per_wave, float eps,
                                 void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  Params p{};
  if (!plan_params(p, B, C, G, HW, channels_last, vec, splits, vps, stage_vectors, units_per_wave, 1, false))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = y;
  p.stats = static_cast<float*>(stats);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.eps = eps;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch<T, decltype(v)::value, decltype(cl)::value, false>(p, s);
  });
}

// K6. x, ct, dx: (B, C, HW) NCHW-contiguous or (B, HW, C) channels_last, one
// dtype (codes as K5's); w: (C,) float32; stats: K5's (2, B*G) mean and
// rstd; dwb: (2, C) float32 output (dw, dbias); part: (units, splits,
// slots) float32 scratch (slots 2 + 128 NCHW, 2*G + 2*C channels_last);
// rows: (2, B*C) float32 scratch; counters: (1 + units,) int32, zero, left
// zero. vec and the plan as K5's; piece: NCHW, the vectors a warp reduces
// at a time.
extern "C" int group_norm_bwd_launch(const void* x, const void* ct, const void* w, const void* stats, void* dx,
                                     void* dwb, void* part, void* rows, void* counters, int B, int C,
                                     int G, long long HW, int channels_last, int dtype, int vec, int splits, int vps,
                                     int stage_vectors, int units_per_wave, int piece, void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  Params p{};
  if (!plan_params(p, B, C, G, HW, channels_last, vec, splits, vps, stage_vectors, units_per_wave, piece, true))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.ct = ct;
  p.w = static_cast<const float*>(w);
  p.stats_in = static_cast<const float*>(stats);
  p.out = dx;
  p.dwb = static_cast<float*>(dwb);
  p.part = static_cast<float*>(part);
  p.rows = static_cast<float*>(rows);
  p.counters = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch<T, decltype(v)::value, decltype(cl)::value, true>(p, s);
  });
}

// ------------------------------------------------ the sharded norm ----
//
// A norm whose activations are cut into shards over several cards (rows,
// or channels where a group straddles cards: models/layers.py:
// sharded_group_norm) takes two launches of each kernel on each shard: the
// partials launch (Mode kPartials) writes the shard's share of the sums a
// statistic needs, the wrapper sums them over the shards in a fixed order,
// and the apply launch (Mode kApply) writes the shard's y or dx from the
// result. A shard's units are those of a tensor of its own channels, in
// groups that lie within one group of the whole. Nothing is staged: each
// launch reads its inputs once.

// The capacity of the partials (mode 1) or apply (mode 2) kernel, as
// group_norm_capacity's.
extern "C" int group_norm_shard_capacity(int backward, int mode, int dtype, int vec, int channels_last, int* out) {
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(v)::value;
    constexpr bool CL = decltype(cl)::value;
    Info in{};
    int err = static_cast<int>(cudaErrorInvalidValue);
    if (mode == kPartials) {
      err = backward ? kernel_info<T, V, CL, true, kPartials>(&in) : kernel_info<T, V, CL, false, kPartials>(&in);
    } else if (mode == kApply) {
      err = backward ? kernel_info<T, V, CL, true, kApply>(&in) : kernel_info<T, V, CL, false, kApply>(&in);
    }
    if (err) return err;
    out[0] = in.per_sm;
    out[1] = in.sms;
    out[2] = in.smem - kScratchBytes;
    return 0;
  });
}

// K5's partials launch: sums (2, B*G) float32 output, sum(x) then
// sum(x*x) of each (b, g); x, part, counters and the plan as K5's, nothing
// staged.
extern "C" int group_norm_partials_launch(const void* x, void* sums, void* part, void* counters, int B, int C, int G,
                                          long long HW, int channels_last, int dtype, int vec, int splits, int vps,
                                          int units_per_wave, void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  Params p{};
  if (!plan_params(p, B, C, G, HW, channels_last, vec, splits, vps, 0, units_per_wave, 1, false))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.stats = static_cast<float*>(sums);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch<T, decltype(v)::value, decltype(cl)::value, false, kPartials>(p, s);
  });
}

// K5's apply launch: y from x and the given (2, B*G) mean and rstd; no
// barrier, no scratch.
extern "C" int group_norm_apply_launch(const void* x, const void* w, const void* bias, const void* stats, void* y,
                                       int B, int C, int G, long long HW, int channels_last, int dtype, int vec,
                                       int splits, int vps, int units_per_wave, void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  Params p{};
  if (!plan_params(p, B, C, G, HW, channels_last, vec, splits, vps, 0, units_per_wave, 1, false))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.stats_in = static_cast<const float*>(stats);
  p.out = y;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch<T, decltype(v)::value, decltype(cl)::value, false, kApply>(p, s);
  });
}

// K6's partials launch: rows (2, B*C) float32 output, rstd * sum(ct * (x -
// mean)) then sum(ct) of each (b, c), about stats' (2, B*G) mean; part,
// counters and the plan as K6's, nothing staged.
extern "C" int group_norm_bwd_partials_launch(const void* x, const void* ct, const void* stats, void* rows, void* part,
                                              void* counters, int B, int C, int G, long long HW, int channels_last,
                                              int dtype, int vec, int splits, int vps, int units_per_wave, int piece,
                                              void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  Params p{};
  if (!plan_params(p, B, C, G, HW, channels_last, vec, splits, vps, 0, units_per_wave, piece, true))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.ct = ct;
  p.stats_in = static_cast<const float*>(stats);
  p.rows = static_cast<float*>(rows);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch<T, decltype(v)::value, decltype(cl)::value, true, kPartials>(p, s);
  });
}

// K6's apply launch: dx from x, ct, w, stats' (2, B*G) mean and rstd and
// coef's (2, B*G) coefficients (the factor of x - mean, the term added);
// no barrier, no scratch.
extern "C" int group_norm_bwd_apply_launch(const void* x, const void* ct, const void* w, const void* stats,
                                           const void* coef, void* dx, int B, int C, int G, long long HW,
                                           int channels_last, int dtype, int vec, int splits, int vps,
                                           int units_per_wave, int piece, void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  Params p{};
  if (!plan_params(p, B, C, G, HW, channels_last, vec, splits, vps, 0, units_per_wave, piece, true))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.ct = ct;
  p.w = static_cast<const float*>(w);
  p.stats_in = static_cast<const float*>(stats);
  p.coef = static_cast<const float*>(coef);
  p.out = dx;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch<T, decltype(v)::value, decltype(cl)::value, true, kApply>(p, s);
  });
}
