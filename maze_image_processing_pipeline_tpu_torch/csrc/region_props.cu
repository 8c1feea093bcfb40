// K7: the one-pass partials of the fused region measurement
// (ops/regionprops_fused.py), for Hopper.
//
// Replaces the Pallas TPU kernel `regionprops_fused_pallas` of
// attic/pallas_props.py (its `_pass1_kernel`). For each frame b and region r
// in [0, R) (labels outside [0, R) are not measured) it computes, in one read
// of the labels and the uint8 intensity:
//
//   sums[b, r, :]        n1, n065, sum I, sum I*y, sum I*x      (int64)
//   rowcnt[b, y, r]      pixels of r in row y                   (int32)
//   rowsumx[b, y, r]     sum of their x                         (int32)
//   rowminx / rowmaxx    min / max of their x; W / -1 if none   (int32)
//   colcnt[b, x, r]      pixels of r in column x                (int32)
//
// n1 and n065 count the perimeter: every 2x2 block of the zero-padded
// foreground mask (label > 0) has the marching-squares length 0, 0.65, 1.0
// or 1.3 (ops/regionprops.py) and is given to its raster-last foreground
// corner pixel; a pixel of r adds the blocks of length 1.0 to n1 and the
// 0.65-units to n065 (a block of 1.3 is two units). The wrapper returns
// n1 + n065 * float(0.65) summed in float64, which is the plain version's
// float64 sum of the same terms bit for bit. The histogram is K3's kernel
// (csrc/region_histogram.cu), which the same wrapper launches.
//
// Bound: device-memory bandwidth. The function reads the labels (4 B/px) and
// the intensity (1 B/px) once and writes the partials: (B, R, 5) int64,
// 4 x (B, H, R) and (B, W, R) int32; 63.5 MB at (8, 1024, 1280) with R = 64,
// 18.9 us at 3.35 TB/s.
//
// Design: one block per (strip of TH whole rows, frame), 256 threads; the
// block walks its strip row by row, a warp on 32 neighbouring pixels of one
// row. The lanes holding the same label are found with __match_any_sync, and
// the warp-reduce intrinsics (__reduce_add/min/max_sync over that group)
// give the group's count, x-sum, x-min, x-max and intensity sums, which one
// lane adds to the block's shared accumulators: per (row of the strip,
// region) count / x-sum / x-min / x-max, and per region the int64 sums. A
// frame is mostly background, so this is one shared atomic per warp and row
// for most of it. The block owns its rows, so it writes the per-row partials
// of every (row, region) itself, without atomics or zeroed outputs. Each
// column is walked by one thread, which keeps the run of equal labels in
// shared memory and adds a finished run to the global column counts with one
// integer atomic. The per-region sums leave the same way at the block's end.
// Integer atomics make every partial exact and the same in every run. The
// perimeter needs the 3x3 foreground neighbourhood of each foreground pixel,
// so a strip reads the row above and the row below it again (L1/L2 hits).
//
// The entry point returns the first non-zero CUDA error code of its set-up
// and launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 16;                   // rows per strip
constexpr size_t kBudget = 200 * 1024;         // shared bytes a block may take
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool fg_at(const int32_t* __restrict__ l, int H,
                                      int W, int y, int x) {
  return y >= 0 && y < H && x >= 0 && x < W && l[static_cast<long long>(y) * W + x] > 0;
}

// One 2x2 block with corners a=(i-1,j-1), b=(i-1,j), c=(i,j-1), d=(i,j).
__device__ __forceinline__ void add_block(bool a, bool b, bool c, bool d, int& n1,
                                          int& n065) {
  const int count = a + b + c + d;
  if (count == 1 || count == 3) {
    n065 += 1;
  } else if (count == 2) {
    if (a == d) n065 += 2;  // a diagonal pair: two corner cuts
    else n1 += 1;
  }
}

// The perimeter units the foreground pixel (y, x) receives (the blocks of
// which it is the raster-last foreground corner).
__device__ __forceinline__ void perimeter_units(const int32_t* __restrict__ l,
                                                int H, int W, int y, int x,
                                                int& n1, int& n065) {
  const bool nw = fg_at(l, H, W, y - 1, x - 1), n = fg_at(l, H, W, y - 1, x);
  const bool ne = fg_at(l, H, W, y - 1, x + 1), w = fg_at(l, H, W, y, x - 1);
  const bool e = fg_at(l, H, W, y, x + 1), sw = fg_at(l, H, W, y + 1, x - 1);
  const bool s = fg_at(l, H, W, y + 1, x), se = fg_at(l, H, W, y + 1, x + 1);
  add_block(nw, n, w, true, n1, n065);                     // block (y, x): corner d
  if (!e) add_block(n, ne, true, e, n1, n065);             // block (y, x+1): corner c
  if (!sw && !s) add_block(w, true, sw, s, n1, n065);      // block (y+1, x): corner b
  if (!e && !s && !se) add_block(true, e, s, se, n1, n065);  // block (y+1, x+1): corner a
}

__global__ void region_props_kernel(
    const int32_t* __restrict__ lab, const uint8_t* __restrict__ img,
    unsigned long long* __restrict__ sums, int32_t* __restrict__ rowcnt,
    int32_t* __restrict__ rowsumx, int32_t* __restrict__ rowminx,
    int32_t* __restrict__ rowmaxx, int32_t* __restrict__ colcnt, int H, int W,
    int R, int TH) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_sums = smem;                                // (R, 5)
  int* s_cnt = reinterpret_cast<int*>(s_sums + 5 * R);              // (TH, R)
  int* s_sumx = s_cnt + TH * R;
  int* s_minx = s_sumx + TH * R;
  int* s_maxx = s_minx + TH * R;
  int2* s_col = reinterpret_cast<int2*>(s_maxx + TH * R);  // (W,), 8-byte aligned

  const int frame = blockIdx.y;
  const int y0 = blockIdx.x * TH;
  const int rows = min(TH, H - y0);
  for (int i = threadIdx.x; i < 5 * R; i += blockDim.x) s_sums[i] = 0;
  for (int i = threadIdx.x; i < TH * R; i += blockDim.x) {
    s_cnt[i] = 0;
    s_sumx[i] = 0;
    s_minx[i] = W;
    s_maxx[i] = -1;
  }
  for (int x = threadIdx.x; x < W; x += blockDim.x) s_col[x] = make_int2(-1, 0);
  __syncthreads();

  const long long HW = static_cast<long long>(H) * W;
  const int32_t* l = lab + frame * HW;
  const uint8_t* v = img ? img + frame * HW : nullptr;
  int32_t* col = colcnt + static_cast<long long>(frame) * W * R;
  const int lane = threadIdx.x & 31;
  for (int yl = 0; yl < rows; ++yl) {
    const int y = y0 + yl;
    // Uniform bounds: whole warps enter each step.
    for (int x0 = 0; x0 < W; x0 += blockDim.x) {
      const int x = x0 + threadIdx.x;
      const bool in = x < W;
      const unsigned active = __ballot_sync(kFull, in);
      if (!in) continue;
      const int r = l[static_cast<long long>(y) * W + x];
      const bool valid = r >= 0 && r < R;
      const unsigned iv = v ? v[static_cast<long long>(y) * W + x] : 0u;
      int n1 = 0, n065 = 0;
      if (valid && r > 0) perimeter_units(l, H, W, y, x, n1, n065);
      const unsigned peers = __match_any_sync(active, valid ? r : -1);
      const unsigned ux = static_cast<unsigned>(x);
      const unsigned sumx = __reduce_add_sync(peers, ux);
      const unsigned minx = __reduce_min_sync(peers, ux);
      const unsigned maxx = __reduce_max_sync(peers, ux);
      const unsigned si = __reduce_add_sync(peers, iv);
      const unsigned six = __reduce_add_sync(peers, iv * ux);
      const unsigned s1 = __reduce_add_sync(peers, static_cast<unsigned>(n1));
      const unsigned s065 = __reduce_add_sync(peers, static_cast<unsigned>(n065));
      if (valid && lane == __ffs(peers) - 1) {
        const int k = yl * R + r;
        atomicAdd(&s_cnt[k], __popc(peers));
        atomicAdd(&s_sumx[k], static_cast<int>(sumx));
        atomicMin(&s_minx[k], static_cast<int>(minx));
        atomicMax(&s_maxx[k], static_cast<int>(maxx));
        unsigned long long* s = s_sums + 5 * r;
        if (s1) atomicAdd(&s[0], static_cast<unsigned long long>(s1));
        if (s065) atomicAdd(&s[1], static_cast<unsigned long long>(s065));
        if (si) {
          atomicAdd(&s[2], static_cast<unsigned long long>(si));
          atomicAdd(&s[3], static_cast<unsigned long long>(si) * y);
          atomicAdd(&s[4], static_cast<unsigned long long>(six));
        }
      }
      if (valid) {  // the column's run of equal labels (this thread's column)
        int2 c = s_col[x];
        if (c.x == r) {
          c.y += 1;
        } else {
          if (c.y) atomicAdd(&col[static_cast<long long>(x) * R + c.x], c.y);
          c = make_int2(r, 1);
        }
        s_col[x] = c;
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int2 c = s_col[x];
    if (c.y) atomicAdd(&col[static_cast<long long>(x) * R + c.x], c.y);
  }
  const long long row0 = (static_cast<long long>(frame) * H + y0) * R;
  for (int i = threadIdx.x; i < rows * R; i += blockDim.x) {
    rowcnt[row0 + i] = s_cnt[i];
    rowsumx[row0 + i] = s_sumx[i];
    rowminx[row0 + i] = s_minx[i];
    rowmaxx[row0 + i] = s_maxx[i];
  }
  unsigned long long* g = sums + static_cast<long long>(frame) * 5 * R;
  for (int i = threadIdx.x; i < 5 * R; i += blockDim.x) {
    if (s_sums[i]) atomicAdd(&g[i], s_sums[i]);
  }
}

size_t smem_bytes(int R, int TH, int W) {
  return 5 * static_cast<size_t>(R) * sizeof(unsigned long long) +
         4 * static_cast<size_t>(TH) * R * sizeof(int) + static_cast<size_t>(W) * sizeof(int2);
}

}  // namespace

// lab: (B, H, W) int32; img: (B, H, W) uint8 or null; sums: (B, R, 5) int64
// and colcnt: (B, W, R) int32, zeroed by the caller; rowcnt, rowsumx,
// rowminx, rowmaxx: (B, H, R) int32. All contiguous.
extern "C" int region_props_launch(const void* lab, const void* img, void* sums,
                                   void* rowcnt, void* rowsumx, void* rowminx,
                                   void* rowmaxx, void* colcnt, int B, int H,
                                   int W, int R, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (R <= 0 || B > 65535 || W > (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);
  int TH = kMaxRows;
  while (TH > 1 && smem_bytes(R, TH, W) > kBudget) TH /= 2;
  const size_t smem = smem_bytes(R, TH, W);
  if (smem > kBudget) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_props_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = W >= kMaxThreads ? kMaxThreads : (W + 31) / 32 * 32;
  const dim3 grid(static_cast<unsigned>((H + TH - 1) / TH), B);
  region_props_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lab), static_cast<const uint8_t*>(img),
      static_cast<unsigned long long*>(sums), static_cast<int32_t*>(rowcnt),
      static_cast<int32_t*>(rowsumx), static_cast<int32_t*>(rowminx),
      static_cast<int32_t*>(rowmaxx), static_cast<int32_t*>(colcnt), H, W, R, TH);
  return static_cast<int>(cudaGetLastError());
}
