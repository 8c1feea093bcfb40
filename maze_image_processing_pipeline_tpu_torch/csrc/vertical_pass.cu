// K4: the vertical pass of the connected-component labelling
// (ops/label.py:vertical_pass), for Hopper.
//
// Replaces the Pallas TPU kernel `vertical_pass_pallas` of
// attic/pallas_label.py (and the strip walk `_vertical_pass` of
// maze_image_processing_pipeline_tpu/ops/label.py). For each frame, rows in
// order (top to bottom, or bottom to top with `reverse`):
//
//   carry = INF (2**30) before the first row;
//   carry[c] = fg[r, c] ? min(lab[r, c], N(carry)[c]) : INF;
//   out[r, :] = carry,
//
// where N(carry) is carry itself for 4-connectivity and the minimum over
// columns c-1, c, c+1 (INF beyond the edges) for 8-connectivity.
//
// Bound: latency. The bytes are small (lab 4 B + fg 1 B read, out 4 B
// written: 9 B/px, 94 MB at (8, 1024, 1280), 28 us at 3.35 TB/s), but row r
// depends on row r-1, so a frame is H sequential steps.
//
// Design, not the TPU's strip grid:
// * 8-connectivity: column c needs columns c-1..c+1 of the previous row, so
//   column bands are not independent. One block per frame; its threads
//   stride over W (PER columns each, PER in {1, 2, 4, 8}, so W <= 8192).
//   The previous row's carry sits in shared memory, double-buffered
//   (2*W int32), so a row costs one __syncthreads(). Each thread loads row
//   r+1's lab and fg into registers before row r's barrier, so the global
//   load latency overlaps the exchange.
// * 4-connectivity: columns are independent. One thread per (frame,
//   column), no barrier, a grid over B*W; neighbouring threads read
//   neighbouring columns, so every row step is a coalesced load.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns the cudaGetLastError() code of the launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;  // background label of the CCL
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 8;
constexpr int kThreads4 = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

template <int PER>
__global__ void vpass8_kernel(const int32_t* __restrict__ lab,
                              const uint8_t* __restrict__ fg,
                              int32_t* __restrict__ out, int H, int W,
                              int reverse) {
  extern __shared__ int32_t carry[];  // two rows of W
  const long long base = static_cast<long long>(blockIdx.x) * H * W;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int step = reverse ? -1 : 1;
  const int r0 = reverse ? H - 1 : 0;

  for (int c = tid; c < W; c += T) carry[c] = kInf;

  int cur_l[PER];
  bool cur_f[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = tid + k * T;
    cur_l[k] = kInf;
    cur_f[k] = false;
    if (c < W) {
      const long long i = base + static_cast<long long>(r0) * W + c;
      cur_l[k] = lab[i];
      cur_f[k] = fg[i] != 0;
    }
  }
  __syncthreads();

  int src = 0;
  for (int n = 0; n < H; ++n) {
    const int r = r0 + n * step;
    const int32_t* prev = carry + src * W;
    int32_t* next = carry + (src ^ 1) * W;

    // Row r+1's inputs are in flight while row r is computed and exchanged.
    int nxt_l[PER];
    bool nxt_f[PER];
    const bool more = n + 1 < H;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = tid + k * T;
      nxt_l[k] = kInf;
      nxt_f[k] = false;
      if (more && c < W) {
        const long long i = base + static_cast<long long>(r + step) * W + c;
        nxt_l[k] = lab[i];
        nxt_f[k] = fg[i] != 0;
      }
    }

#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = tid + k * T;
      if (c < W) {
        int m = prev[c];
        if (c > 0) m = min(m, prev[c - 1]);
        if (c + 1 < W) m = min(m, prev[c + 1]);
        const int v = cur_f[k] ? min(cur_l[k], m) : kInf;
        next[c] = v;
        out[base + static_cast<long long>(r) * W + c] = v;
      }
    }
    // Every read of `prev` and write of `next` of row r is done before row
    // r+1 writes `prev` (its `next`): one barrier per row.
    __syncthreads();
    src ^= 1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      cur_l[k] = nxt_l[k];
      cur_f[k] = nxt_f[k];
    }
  }
}

__global__ void vpass4_kernel(const int32_t* __restrict__ lab,
                              const uint8_t* __restrict__ fg,
                              int32_t* __restrict__ out, int B, int H, int W,
                              int reverse) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * W) return;
  const long long b = t / W;
  const int c = static_cast<int>(t - b * W);
  const long long col = b * H * W + c;
  const long long stride = reverse ? -static_cast<long long>(W) : W;
  long long i = col + (reverse ? static_cast<long long>(H - 1) * W : 0);
  int carry = kInf;
#pragma unroll 8
  for (int n = 0; n < H; ++n, i += stride) {
    const int l = lab[i];
    const bool f = fg[i] != 0;
    carry = f ? min(l, carry) : kInf;
    out[i] = carry;
  }
}

template <int PER>
int launch8(const int32_t* lab, const uint8_t* fg, int32_t* out, int B, int H,
            int W, int reverse, cudaStream_t stream) {
  const int threads = ((W + PER - 1) / PER + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(W) * sizeof(int32_t);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        vpass8_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vpass8_kernel<PER><<<B, threads, smem, stream>>>(lab, fg, out, H, W, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lab, out: (B, H, W) int32; fg: (B, H, W) bool/uint8; all contiguous.
// connectivity: 1 (4-connected) or 2 (8-connected, W <= 8192).
extern "C" int vertical_pass_launch(const void* lab, const void* fg, void* out,
                                    int B, int H, int W, int connectivity,
                                    int reverse, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const auto* l = static_cast<const int32_t*>(lab);
  const auto* f = static_cast<const uint8_t*>(fg);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (connectivity == 1) {
    const long long n = static_cast<long long>(B) * W;
    const unsigned blocks = static_cast<unsigned>((n + kThreads4 - 1) / kThreads4);
    vpass4_kernel<<<blocks, kThreads4, 0, s>>>(l, f, o, B, H, W, reverse);
    return static_cast<int>(cudaGetLastError());
  }
  if (connectivity != 2) return static_cast<int>(cudaErrorInvalidValue);
  int per = 1;
  while (per <= kMaxPer && (W + per - 1) / per > kMaxThreads) per *= 2;
  switch (per) {
    case 1: return launch8<1>(l, f, o, B, H, W, reverse, s);
    case 2: return launch8<2>(l, f, o, B, H, W, reverse, s);
    case 4: return launch8<4>(l, f, o, B, H, W, reverse, s);
    case 8: return launch8<8>(l, f, o, B, H, W, reverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
