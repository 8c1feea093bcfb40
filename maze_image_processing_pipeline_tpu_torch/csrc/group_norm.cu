// K5: GroupNorm forward of every U-Net and classifier norm
// (models/layers.py:group_norm), for Hopper.
//
// Replaces the Pallas TPU kernel `group_norm_pallas` of attic/pallas_norm.py
// (and the XLA `_group_norm_ref` of
// maze_image_processing_pipeline_tpu/models/layers.py). For x of shape
// (B, C, *spatial) with HW spatial elements, G groups of Cg = C / G
// consecutive channels and n = Cg * HW elements a group:
//
//   mean[b, g] = sum(x) / n,  var = max(sum(x*x) / n - mean^2, 0)  (float32)
//   rstd[b, g] = 1 / sqrt(var + eps)
//   y = (x - mean[b, g(c)]) * (rstd[b, g(c)] * w[c]) + bias[c]
//
// computed in float32 and stored in x's dtype (float32, bfloat16, float16),
// the formula and rounding steps of the plain version.
//
// Layouts: x is NCHW-contiguous (any number of spatial axes) or, 4-D,
// channels_last (NHWC in memory), as cuDNN returns convolution outputs for a
// channels_last input; y has the layout of x. The wrapper raises on any
// other layout.
//
// Bound: device-memory bandwidth. The function reads x once and writes y
// once: 2 * numel * itemsize bytes, 0.641 ms at (16, 32, 1024, 1024) bf16 at
// 3.35 TB/s. This design reads x twice (statistics, then apply), so it can
// reach at most about 67 % of that bound.
//
// Design, two launches on one stream:
// 1. gn_stats_kernel: grid (G, splits, B); each block reduces one share of
//    one (b, g) group (a run of units: V consecutive elements in NCHW, one
//    pixel's Cg channels in channels_last) with V-element vector loads
//    (16 bytes where the shape and alignment allow), float32 accumulation,
//    warp shuffles and a fixed-order combine of the warps. Its float32
//    partials go to a (B*G, splits) buffer. The last block of a group to
//    finish (an integer counter, so no float atomics) sums the group's
//    partials in split order and writes mean and rstd: the result does not
//    depend on which block finished last.
// 2. gn_apply_kernel: a grid-stride elementwise pass over V-element vectors
//    of x, reading mean/rstd of its (b, g) and w/bias of its channels.
//
// The entry point returns the first non-zero cudaGetLastError() code of its
// launches (0 = launched).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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
int launch(const void* x, const void* w, const void* bias, void* y, void* part,
           void* stats, void* counters, int B, int C, int G, long long HW,
           long long units_per_split, int splits, float eps, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  auto* pt = static_cast<float*>(part);
  auto* st = static_cast<float*>(stats);
  const float n = static_cast<float>(static_cast<long long>(C / G) * HW);
  const dim3 grid(G, splits, B);
  gn_stats_kernel<T, V, CL><<<grid, kThreads, 0, s>>>(
      xt, pt, st, static_cast<int*>(counters), C, G, HW, units_per_split, splits, n, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_vec = static_cast<long long>(B) * C * HW / V;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const long long cap = 32LL * sms;  // 32 blocks an SM, grid-stride beyond
  const long long blocks = want < cap ? want : cap;
  gn_apply_kernel<T, V, CL><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xt, static_cast<const float*>(w), static_cast<const float*>(bias), st,
      static_cast<T*>(y), B, C, G, HW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_layout(int channels_last, const void* x, const void* w, const void* bias, void* y,
                  void* part, void* stats, void* counters, int B, int C, int G, long long HW,
                  long long ups, int splits, float eps, cudaStream_t s) {
  return channels_last
             ? launch<T, V, true>(x, w, bias, y, part, stats, counters, B, C, G, HW, ups, splits, eps, s)
             : launch<T, V, false>(x, w, bias, y, part, stats, counters, B, C, G, HW, ups, splits, eps, s);
}

template <typename T>
int launch_vec(int vec, int channels_last, const void* x, const void* w, const void* bias,
               void* y, void* part, void* stats, void* counters, int B, int C, int G,
               long long HW, long long ups, int splits, float eps, cudaStream_t s) {
  switch (vec) {
    case 1: return launch_layout<T, 1>(channels_last, x, w, bias, y, part, stats, counters, B, C, G, HW, ups, splits, eps, s);
    case 2: return launch_layout<T, 2>(channels_last, x, w, bias, y, part, stats, counters, B, C, G, HW, ups, splits, eps, s);
    case 4: return launch_layout<T, 4>(channels_last, x, w, bias, y, part, stats, counters, B, C, G, HW, ups, splits, eps, s);
    case 8:
      if (sizeof(T) <= 2)
        return launch_layout<T, (sizeof(T) <= 2 ? 8 : 4)>(channels_last, x, w, bias, y, part, stats,
                                                          counters, B, C, G, HW, ups, splits, eps, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: (B, C, HW) NCHW-contiguous or (B, HW, C) channels_last, dtype 0 =
// float32, 1 = bfloat16, 2 = float16; w, bias: (C,) float32; part: (2, B*G,
// splits) float32 scratch; stats: (2, B*G) float32 (mean, rstd) scratch;
// counters: (B*G,) int32, zeroed by the caller. vec: elements
// per load, dividing HW (NCHW) or Cg (channels_last), with x and y aligned
// to vec * itemsize. units_per_split * splits covers the group's
// units (NCHW: Cg*HW/vec vectors; channels_last: HW pixels).
extern "C" int group_norm_launch(const void* x, const void* w, const void* bias, void* y,
                                 void* part, void* stats, void* counters, int B, int C, int G,
                                 long long HW, int channels_last, int dtype, int vec,
                                 long long units_per_split, int splits, float eps,
                                 void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  if (C <= 0 || G <= 0 || C % G || B > 65535 || G > 65535 || splits <= 0 || splits > 65535 ||
      units_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((channels_last ? (C / G) % vec : HW % vec) != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (vec > 4) return static_cast<int>(cudaErrorInvalidValue);
      return launch_vec<float>(vec, channels_last, x, w, bias, y, part, stats, counters, B, C, G, HW,
                               units_per_split, splits, eps, s);
    case 1:
      return launch_vec<__nv_bfloat16>(vec, channels_last, x, w, bias, y, part, stats, counters, B, C,
                                       G, HW, units_per_split, splits, eps, s);
    case 2:
      return launch_vec<__half>(vec, channels_last, x, w, bias, y, part, stats, counters, B, C, G, HW,
                                units_per_split, splits, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
