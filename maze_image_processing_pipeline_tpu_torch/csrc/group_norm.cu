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
// itemsize, 0.120 ms at (8, 32, 512, 512) bf16. Both designs read their
// inputs twice (statistics, then the elementwise pass), so K5 can reach at
// most about 67 % of its bound and K6 about 60 %.
//
// Design, two launches each on one stream:
// 1. gn_stats_kernel (K5): grid (G, splits, B); each block reduces one share
//    of one (b, g) group (a run of units: V consecutive elements in NCHW,
//    one pixel's Cg channels in channels_last) with V-element vector loads
//    (16 bytes where the shape and alignment allow), float32 accumulation,
//    warp shuffles and a fixed-order combine of the warps. Its float32
//    partials go to a (B*G, splits) buffer. The last block of a group to
//    finish (an integer counter, so no float atomics) sums the group's
//    partials in split order and writes mean and rstd: the result does not
//    depend on which block finished last.
//    gn_bwd_reduce_kernel (K6) does the same per channel: NCHW, grid
//    (C, splits, B), a block per share of one (b, c) plane; channels_last,
//    grid (G, splits, B), a block per share of one group's pixels, each
//    thread holding one V-channel vector of its pixels and the block's rows
//    combined per channel in row order in shared memory. Partials go to a
//    (2, B*C, splits) buffer; the group's last block sums them in split
//    order, writes the (b, c) dw/dbias rows and the group's two dx
//    constants.
// 2. gn_apply_kernel / gn_bwd_apply_kernel: a grid-stride elementwise pass
//    over V-element vectors of x (and ct), reading the (b, g) constants and
//    the per-channel parameters. K6's first block also sums the dw/dbias
//    rows over b in order.
//
// The entry points return the first non-zero cudaGetLastError() code of
// their launches (0 = launched).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// Sum of a float over the block, in a fixed order (shuffle tree in each
// warp, then the warps in order); valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  }
  return s;
}

// Grid-stride blocks for an elementwise pass over n_vec vectors: 32 blocks
// an SM at most. Sets *blocks; returns a CUDA error code.
int elementwise_blocks(long long n_vec, unsigned* blocks) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const long long cap = 32LL * sms;
  *blocks = static_cast<unsigned>(want < cap ? want : cap);
  return 0;
}

// ---------------------------------------------------------------- K5 ----

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                float* __restrict__ stats, int* __restrict__ counters, int C,
                int G, long long HW, long long units_per_split, int splits,
                float n, float eps) {
  __shared__ float scratch[32];
  __shared__ bool last;
  const int g = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int Cg = C / G;
  const long long bg = static_cast<long long>(b) * G + g;
  // Units of this (b, g): NCHW, Cg*HW/V vectors from one contiguous run;
  // channels_last, HW pixels of Cg/V vectors each, C elements apart.
  const int vpp = Cg / V;  // vectors per pixel (channels_last)
  const long long n_units = CL ? HW : static_cast<long long>(Cg) * HW / V;
  const long long u0 = split * units_per_split;
  const long long u1 = min(n_units, u0 + units_per_split);
  float s1 = 0.f, s2 = 0.f;
  if (CL) {
    const T* base = x + static_cast<long long>(b) * HW * C + static_cast<long long>(g) * Cg;
    const long long n_vec = (u1 - u0) * vpp;
    for (long long k = threadIdx.x; k < n_vec; k += blockDim.x) {
      const long long p = u0 + k / vpp;
      const int j = static_cast<int>(k % vpp) * V;
      const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(base + p * C + j);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f(v.v[e]);
        s1 += f;
        s2 = fmaf(f, f, s2);
      }
    }
  } else {
    const T* base = x + (static_cast<long long>(b) * C + static_cast<long long>(g) * Cg) * HW;
    for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
      const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(base + u * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f(v.v[e]);
        s1 += f;
        s2 = fmaf(f, f, s2);
      }
    }
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  const long long nb = static_cast<long long>(gridDim.z) * G;  // B*G
  if (threadIdx.x == 0) {
    part[bg * splits + split] = s1;
    part[(nb + bg) * splits + split] = s2;
    __threadfence();
    last = atomicAdd(&counters[bg], 1) == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  // The group's last block: its partials in split order.
  float t1 = 0.f, t2 = 0.f;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    t1 += __ldcg(&part[bg * splits + s]);
    t2 += __ldcg(&part[(nb + bg) * splits + s]);
  }
  t1 = block_sum(t1, scratch);
  t2 = block_sum(t2, scratch);
  if (threadIdx.x == 0) {
    const float mean = __fdiv_rn(t1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(t2, n), __fmul_rn(mean, mean)), 0.f);
    stats[bg] = mean;
    stats[nb + bg] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ stats,
                T* __restrict__ y, int B, int C, int G, long long HW) {
  const int Cg = C / G;
  const long long nb = static_cast<long long>(B) * G;
  const long long n_vec = static_cast<long long>(B) * C * HW / V;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < n_vec;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = u * V;
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(x + i);
    Vec<T, V> out;
    if (CL) {  // V consecutive channels of one pixel
      const int c0 = static_cast<int>(i % C);
      const long long b = i / (HW * C);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = c0 + e;
        const long long bg = b * G + c / Cg;
        const float scale = __fmul_rn(__ldg(&stats[nb + bg]), __ldg(&w[c]));
        out.v[e] = from_f<T>(
            __fadd_rn(__fmul_rn(__fsub_rn(to_f(v.v[e]), __ldg(&stats[bg])), scale), __ldg(&bias[c])));
      }
    } else {  // V consecutive pixels of one channel
      const long long bc = i / HW;
      const int c = static_cast<int>(bc % C);
      const long long bg = (bc / C) * G + c / Cg;
      const float mean = __ldg(&stats[bg]);
      const float scale = __fmul_rn(__ldg(&stats[nb + bg]), __ldg(&w[c]));
      const float bb = __ldg(&bias[c]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        out.v[e] = from_f<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_f(v.v[e]), mean), scale), bb));
      }
    }
    *reinterpret_cast<Vec<T, V>*>(y + i) = out;
  }
}

template <typename T, int V, bool CL>
int launch_fwd(const void* x, const void* w, const void* bias, void* y, void* part, void* stats,
               void* counters, int B, int C, int G, long long HW, long long units_per_split,
               int splits, float eps, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  auto* st = static_cast<float*>(stats);
  const float n = static_cast<float>(static_cast<long long>(C / G) * HW);
  gn_stats_kernel<T, V, CL><<<dim3(G, splits, B), kThreads, 0, s>>>(
      xt, static_cast<float*>(part), st, static_cast<int*>(counters), C, G, HW, units_per_split,
      splits, n, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned blocks = 0;
  if (int err = elementwise_blocks(static_cast<long long>(B) * C * HW / V, &blocks)) return err;
  gn_apply_kernel<T, V, CL><<<blocks, kThreads, 0, s>>>(
      xt, static_cast<const float*>(w), static_cast<const float*>(bias), st, static_cast<T*>(y), B,
      C, G, HW);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K6 ----

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                     const float* __restrict__ w, const float* __restrict__ stats,
                     float* __restrict__ part, float* __restrict__ rows,
                     float* __restrict__ coef, int* __restrict__ counters, int C, int G,
                     long long HW, long long units_per_split, int splits, float n) {
  __shared__ float scratch[32];
  __shared__ bool last;
  const int Cg = C / G;
  const int split = blockIdx.y, b = blockIdx.z;
  const int g = CL ? static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x) / Cg;
  const long long nb = static_cast<long long>(gridDim.z) * G;  // B*G
  const long long BC = static_cast<long long>(gridDim.z) * C;
  const long long bg = static_cast<long long>(b) * G + g;
  const float mean = __ldg(&stats[bg]);
  if constexpr (CL) {
    // This share's pixels [u0, u1) of group g: vpp vectors of V channels a
    // pixel. Threads form nrows rows of `width` vector columns; a thread
    // keeps one column's V channels over its row's pixels, and the rows are
    // combined per channel in row order.
    __shared__ float acc[2][kThreads * V];
    const int vpp = Cg / V;
    const int width = vpp < kThreads ? vpp : kThreads;
    const int nrows = kThreads / width;
    const int r = threadIdx.x / width, jj = threadIdx.x % width;
    const long long u0 = split * units_per_split;
    const long long u1 = min(HW, u0 + units_per_split);
    const long long base = static_cast<long long>(b) * HW * C + static_cast<long long>(g) * Cg;
    for (int j0 = 0; j0 < vpp; j0 += width) {
      const int j = j0 + jj;
      float s[V], sx[V];
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] = sx[e] = 0.f;
      if (r < nrows && j < vpp) {
        for (long long p = u0 + r; p < u1; p += nrows) {
          const long long off = base + p * C + static_cast<long long>(j) * V;
          const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + off);
          const Vec<T, V> cv = *reinterpret_cast<const Vec<T, V>*>(ct + off);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float c = to_f(cv.v[e]);
            s[e] += c;
            sx[e] = fmaf(c, to_f(xv.v[e]) - mean, sx[e]);
          }
        }
      }
      if (r < nrows) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[0][(r * width + jj) * V + e] = s[e];
          acc[1][(r * width + jj) * V + e] = sx[e];
        }
      }
      __syncthreads();
      for (int cc = threadIdx.x; cc < width * V; cc += blockDim.x) {
        const int ch = j0 * V + cc;
        if (ch < Cg) {
          float t1 = 0.f, t2 = 0.f;
          for (int rr = 0; rr < nrows; ++rr) {
            t1 += acc[0][rr * width * V + cc];
            t2 += acc[1][rr * width * V + cc];
          }
          const long long bc = static_cast<long long>(b) * C + static_cast<long long>(g) * Cg + ch;
          part[bc * splits + split] = t1;
          part[(BC + bc) * splits + split] = t2;
        }
      }
      __syncthreads();  // acc is rewritten by the next chunk of columns
    }
  } else {
    // This share of channel c's plane: vectors [u0, u1) of HW / V.
    const int c = blockIdx.x;
    const long long u0 = split * units_per_split;
    const long long u1 = min(HW / V, u0 + units_per_split);
    const long long bc = static_cast<long long>(b) * C + c;
    const T* xb = x + bc * HW;
    const T* cb = ct + bc * HW;
    float s = 0.f, sx = 0.f;
    for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
      const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(xb + u * V);
      const Vec<T, V> cv = *reinterpret_cast<const Vec<T, V>*>(cb + u * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float cf = to_f(cv.v[e]);
        s += cf;
        sx = fmaf(cf, to_f(xv.v[e]) - mean, sx);
      }
    }
    s = block_sum(s, scratch);
    sx = block_sum(sx, scratch);
    if (threadIdx.x == 0) {
      part[bc * splits + split] = s;
      part[(BC + bc) * splits + split] = sx;
    }
  }
  __threadfence();  // every writer's partials, before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    const int arrivals = CL ? splits : Cg * splits;
    last = atomicAdd(&counters[bg], 1) == arrivals - 1;
  }
  __syncthreads();
  if (!last) return;
  // The group's last block: each channel's partials in split order, its
  // dw/dbias row, then S1, S2 and the group's dx constants.
  const float rstd = __ldg(&stats[nb + bg]);
  float s1 = 0.f, s2 = 0.f;
  for (int cc = threadIdx.x; cc < Cg; cc += blockDim.x) {
    const long long bc = static_cast<long long>(b) * C + static_cast<long long>(g) * Cg + cc;
    float t1 = 0.f, t2 = 0.f;
    for (int s = 0; s < splits; ++s) {
      t1 += __ldcg(&part[bc * splits + s]);
      t2 += __ldcg(&part[(BC + bc) * splits + s]);
    }
    const float dw_row = __fmul_rn(rstd, t2);
    rows[bc] = dw_row;
    rows[BC + bc] = t1;
    const float gamma = __ldg(&w[g * Cg + cc]);
    s1 = __fadd_rn(s1, __fmul_rn(gamma, t1));
    s2 = __fadd_rn(s2, __fmul_rn(gamma, dw_row));
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    coef[bg] = __fdiv_rn(__fmul_rn(__fmul_rn(-rstd, rstd), s2), n);  // times (x - mean)
    coef[nb + bg] = __fdiv_rn(__fmul_rn(-rstd, s1), n);                // added
  }
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                    const float* __restrict__ w, const float* __restrict__ stats,
                    const float* __restrict__ coef, const float* __restrict__ rows,
                    float* __restrict__ dwb, T* __restrict__ dx, int B, int C, int G,
                    long long HW) {
  const int Cg = C / G;
  const long long nb = static_cast<long long>(B) * G;
  if (blockIdx.x == 0) {  // dw, dbias: the (b, c) rows summed over b in order
    const long long BC = static_cast<long long>(B) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float dw = 0.f, db = 0.f;
      for (int b = 0; b < B; ++b) {
        dw += rows[static_cast<long long>(b) * C + c];
        db += rows[BC + static_cast<long long>(b) * C + c];
      }
      dwb[c] = dw;
      dwb[C + c] = db;
    }
  }
  const long long n_vec = static_cast<long long>(B) * C * HW / V;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < n_vec;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = u * V;
    const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + i);
    const Vec<T, V> cv = *reinterpret_cast<const Vec<T, V>*>(ct + i);
    Vec<T, V> out;
    if (CL) {  // V consecutive channels of one pixel
      const int c0 = static_cast<int>(i % C);
      const long long b = i / (HW * C);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = c0 + e;
        const long long bg = b * G + c / Cg;
        const float a = __fmul_rn(__ldg(&stats[nb + bg]), __ldg(&w[c]));
        const float xc = __fsub_rn(to_f(xv.v[e]), __ldg(&stats[bg]));
        out.v[e] = from_f<T>(__fadd_rn(
            __fadd_rn(__fmul_rn(a, to_f(cv.v[e])), __fmul_rn(__ldg(&coef[bg]), xc)), __ldg(&coef[nb + bg])));
      }
    } else {  // V consecutive pixels of one channel
      const long long bc = i / HW;
      const int c = static_cast<int>(bc % C);
      const long long bg = (bc / C) * G + c / Cg;
      const float mean = __ldg(&stats[bg]);
      const float a = __fmul_rn(__ldg(&stats[nb + bg]), __ldg(&w[c]));
      const float cx = __ldg(&coef[bg]), cd = __ldg(&coef[nb + bg]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xc = __fsub_rn(to_f(xv.v[e]), mean);
        out.v[e] = from_f<T>(__fadd_rn(__fadd_rn(__fmul_rn(a, to_f(cv.v[e])), __fmul_rn(cx, xc)), cd));
      }
    }
    *reinterpret_cast<Vec<T, V>*>(dx + i) = out;
  }
}

template <typename T, int V, bool CL>
int launch_bwd(const void* x, const void* ct, const void* w, const void* stats, void* dx,
               void* dwb, void* part, void* rows, void* coef, void* counters, int B, int C, int G,
               long long HW, long long units_per_split, int splits, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  const auto* ctt = static_cast<const T*>(ct);
  const auto* wt = static_cast<const float*>(w);
  const auto* st = static_cast<const float*>(stats);
  auto* rt = static_cast<float*>(rows);
  auto* cf = static_cast<float*>(coef);
  const float n = static_cast<float>(static_cast<long long>(C / G) * HW);
  gn_bwd_reduce_kernel<T, V, CL><<<dim3(CL ? G : C, splits, B), kThreads, 0, s>>>(
      xt, ctt, wt, st, static_cast<float*>(part), rt, cf, static_cast<int*>(counters), C, G, HW,
      units_per_split, splits, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned blocks = 0;
  if (int err = elementwise_blocks(static_cast<long long>(B) * C * HW / V, &blocks)) return err;
  gn_bwd_apply_kernel<T, V, CL><<<blocks, kThreads, 0, s>>>(
      xt, ctt, wt, st, cf, rt, static_cast<float*>(dwb), static_cast<T*>(dx), B, C, G, HW);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- dispatch ----

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

// The arguments both entry points check: shapes within the grid's limits,
// vec dividing HW (NCHW) or Cg (channels_last).
bool valid(int B, int C, int G, long long HW, int channels_last, int vec, long long units_per_split,
           int splits) {
  return C > 0 && G > 0 && C % G == 0 && B <= 65535 && G <= 65535 && splits > 0 && splits <= 65535 &&
         units_per_split > 0 && vec > 0 && (channels_last ? (C / G) % vec : HW % vec) == 0;
}

}  // namespace

// K5. x, y: (B, C, HW) NCHW-contiguous or (B, HW, C) channels_last, dtype 0
// = float32, 1 = bfloat16, 2 = float16; w, bias: (C,) float32; part: (2,
// B*G, splits) float32 scratch; stats: (2, B*G) float32 output (mean,
// rstd); counters: (B*G,) int32, zeroed by the caller. vec: elements per
// load, dividing HW (NCHW) or Cg (channels_last), with x and y aligned to
// vec * itemsize. units_per_split * splits covers the group's units (NCHW:
// Cg*HW/vec vectors; channels_last: HW pixels).
extern "C" int group_norm_launch(const void* x, const void* w, const void* bias, void* y,
                                 void* part, void* stats, void* counters, int B, int C, int G,
                                 long long HW, int channels_last, int dtype, int vec,
                                 long long units_per_split, int splits, float eps,
                                 void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  if (!valid(B, C, G, HW, channels_last, vec, units_per_split, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch_fwd<T, decltype(v)::value, decltype(cl)::value>(
        x, w, bias, y, part, stats, counters, B, C, G, HW, units_per_split, splits, eps, s);
  });
}

// K6. x, ct, dx: (B, C, HW) NCHW-contiguous or (B, HW, C) channels_last, one
// dtype (codes as K5's); w: (C,) float32; stats: K5's (2, B*G) mean and
// rstd; dwb: (2, C) float32 output (dw, dbias); part: (2, B*C, splits),
// rows: (2, B*C), coef: (2, B*G) float32 scratch; counters: (B*G,) int32,
// zeroed by the caller. vec as K5's (x, ct and dx aligned to it).
// units_per_split * splits covers a unit range: NCHW, the HW/vec vectors of
// one channel plane; channels_last, the HW pixels of one group.
extern "C" int group_norm_bwd_launch(const void* x, const void* ct, const void* w,
                                     const void* stats, void* dx, void* dwb, void* part,
                                     void* rows, void* coef, void* counters, int B, int C, int G,
                                     long long HW, int channels_last, int dtype, int vec,
                                     long long units_per_split, int splits, void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  if (!valid(B, C, G, HW, channels_last, vec, units_per_split, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, vec, channels_last, [&](auto t, auto v, auto cl) -> int {
    using T = typename decltype(t)::type;
    return launch_bwd<T, decltype(v)::value, decltype(cl)::value>(
        x, ct, w, stats, dx, dwb, part, rows, coef, counters, B, C, G, HW, units_per_split, splits,
        s);
  });
}
