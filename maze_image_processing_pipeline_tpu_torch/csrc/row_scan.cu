// The row prefix sum of the connected-component labelling (ops/label.py),
// for Hopper, bound to Python through a plain C launcher (ctypes):
//
//   cumsum_rows_launch  K2: the inclusive per-row int32 prefix sum.
//
// (K1, the CCL horizontal pass, lives in ccl.cu with the rest of the CCL.)
// It takes contiguous row-major data of `rows` rows of `W` elements (any
// W >= 1), launches on the caller's stream, allocates nothing, and returns the
// cudaGetLastError() code of the launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per row, 256 threads a block
constexpr unsigned kFull = 0xffffffffu;

// K2. Replaces the Pallas TPU kernel `_cumsum_kernel` of
// maze_image_processing_pipeline_tpu/ops/pallas_scan.py
// (`cumsum_lanes_pallas`): the inclusive int32 prefix sum along each row,
// which ranks the component roots in raster order.
//
// Bound: device-memory bandwidth, 2 int32 passes over B*H*W (one read, one
// write) and one add per pixel and shuffle step.
//
// Design: one warp per row in coalesced 32-element chunks; a 5-step
// shuffle scan within the chunk and the running row total as the carry
// between chunks. Nothing is staged in shared memory.
__global__ void cumsum_rows_kernel(const int32_t* __restrict__ x_in,
                                   int32_t* __restrict__ out,
                                   long long rows, int W) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int32_t* in_r = x_in + row * W;
  int32_t* out_r = out + row * W;
  const int n_chunks = (W + kWarp - 1) / kWarp;

  int carry = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int x = c * kWarp + lane;
    int v = x < W ? in_r[x] : 0;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int ov = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += ov;
    }
    v += carry;
    carry = __shfl_sync(kFull, v, kWarp - 1);
    if (x < W) out_r[x] = v;
  }
}

unsigned grid_for(long long rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" int cumsum_rows_launch(const void* x, void* out, long long rows,
                                  int W, void* stream) {
  if (rows <= 0 || W <= 0) return 0;
  cumsum_rows_kernel<<<grid_for(rows), kRowsPerBlock * kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), rows, W);
  return static_cast<int>(cudaGetLastError());
}
