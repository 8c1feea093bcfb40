// Row scans of the connected-component labelling (ops/label.py), for Hopper.
//
// Two kernels, each bound to Python through a plain C launcher (ctypes):
//
//   hpass_launch        K1: the CCL horizontal pass.
//   cumsum_rows_launch  K2: the inclusive per-row int32 prefix sum.
//
// Both take contiguous row-major data of `rows` rows of `W` elements (any
// W >= 1), launch on the caller's stream, allocate nothing, and return the
// cudaGetLastError() code of the launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per row, 256 threads a block
constexpr int kInf = 1 << 30;     // background label of the CCL
constexpr unsigned kFull = 0xffffffffu;

// K1. Replaces the Pallas TPU kernel `_hpass_kernel` of
// maze_image_processing_pipeline_tpu/ops/pallas_scan.py (`hpass_pallas`):
// every foreground pixel receives the minimum label of its horizontal run;
// background pixels receive kInf.
//
// Bound: device-memory bandwidth. The pass reads the labels (4 B) and the
// mask (1 B) once, writes the forward scan (4 B), reads it back (4 B) and
// writes the result (4 B): about 3 int32 passes over B*H*W, and a handful of
// integer operations per pixel.
//
// Design: one warp owns one row and walks it in 32-pixel chunks, so every
// load and store is one coalesced 128-byte line. Within a chunk a segmented
// min-scan runs in registers over warp shuffles (5 steps); the run minimum
// that is still open at the chunk's end rides to the next chunk as a carry,
// so the row costs no shared memory and no block barrier. The forward pass
// writes its partial result to `out`; the reverse pass walks the chunks
// back, and each lane re-reads only the elements it wrote itself, which stay
// hot in L1/L2. Out-of-row lanes of the last chunk act as background, which
// is exactly the row-edge reset.
__global__ void hpass_kernel(const int32_t* __restrict__ lab,
                             const uint8_t* __restrict__ fg,
                             int32_t* __restrict__ out,
                             long long rows, int W) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int32_t* lab_r = lab + row * W;
  const uint8_t* fg_r = fg + row * W;
  int32_t* out_r = out + row * W;
  const int n_chunks = (W + kWarp - 1) / kWarp;

  // Forward: inclusive segmented min-scan, restarting at background.
  int carry = kInf;
  for (int c = 0; c < n_chunks; ++c) {
    const int x = c * kWarp + lane;
    const bool in_row = x < W;
    const bool on = in_row && fg_r[x] != 0;
    int v = on ? lab_r[x] : kInf;
    int reset = on ? 0 : 1;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int ov = __shfl_up_sync(kFull, v, d);
      const int oreset = __shfl_up_sync(kFull, reset, d);
      if (lane >= d) {
        if (!reset) v = min(v, ov);
        reset |= oreset;
      }
    }
    if (!reset) v = min(v, carry);  // run open since an earlier chunk
    carry = __shfl_sync(kFull, v, kWarp - 1);
    if (in_row) out_r[x] = v;
  }

  // Reverse: the same scan from the right spreads the run minimum to every
  // pixel of the run.
  carry = kInf;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int x = c * kWarp + lane;
    const bool in_row = x < W;
    const bool on = in_row && fg_r[x] != 0;
    int v = on ? out_r[x] : kInf;
    int reset = on ? 0 : 1;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int ov = __shfl_down_sync(kFull, v, d);
      const int oreset = __shfl_down_sync(kFull, reset, d);
      if (lane + d < kWarp) {
        if (!reset) v = min(v, ov);
        reset |= oreset;
      }
    }
    if (!reset) v = min(v, carry);
    carry = __shfl_sync(kFull, v, 0);
    if (in_row) out_r[x] = on ? v : kInf;
  }
}

// K2. Replaces the Pallas TPU kernel `_cumsum_kernel` of
// maze_image_processing_pipeline_tpu/ops/pallas_scan.py
// (`cumsum_lanes_pallas`): the inclusive int32 prefix sum along each row,
// which ranks the component roots in raster order.
//
// Bound: device-memory bandwidth, 2 int32 passes over B*H*W (one read, one
// write) and one add per pixel and shuffle step.
//
// Design: as K1, one warp per row in coalesced 32-element chunks; a 5-step
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

extern "C" int hpass_launch(const void* lab, const void* fg, void* out,
                            long long rows, int W, void* stream) {
  if (rows <= 0 || W <= 0) return 0;
  hpass_kernel<<<grid_for(rows), kRowsPerBlock * kWarp, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lab), static_cast<const uint8_t*>(fg),
      static_cast<int32_t*>(out), rows, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cumsum_rows_launch(const void* x, void* out, long long rows,
                                  int W, void* stream) {
  if (rows <= 0 || W <= 0) return 0;
  cumsum_rows_kernel<<<grid_for(rows), kRowsPerBlock * kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), rows, W);
  return static_cast<int>(cudaGetLastError());
}
