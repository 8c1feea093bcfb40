// K3: per-region 256-bin intensity histograms (ops/region_histogram.py),
// for Hopper.
//
// Replaces the Pallas TPU kernel `region_histogram_pallas` of
// attic/pallas_hist.py. For each frame b, region r in [0, R) and bin c:
//
//   hist[b, r, c] = #{pixels p of frame b : label[p] == r, intensity[p] == c}
//
// with uint8 intensity (the wrapper clips other types to [0, 255] first).
// Labels outside [0, R) are not counted.
//
// Bound: device-memory bandwidth. The function reads the labels (4 B/px) and
// the intensity (1 B/px) once and writes the (B, R, 256) counts: 52.9 MB at
// (8, 1024, 1280) with R = 64, 15.8 us at 3.35 TB/s.
//
// Design: one block per (chunk of kChunk pixels, group of bins, frame). The
// block keeps an (R, nb) uint32 histogram of its bins in shared memory (nb =
// 256 bins while R * 256 counters fit the budget; otherwise the 256 bins are
// split over gridDim.y blocks, each reading the pixels again). A pixel's key
// is (label, bin); the lanes of a warp holding equal keys are found with
// __match_any_sync and one lane adds their number, so the background of a
// frame (one label, few intensities) costs one shared atomic per warp and
// not 32. At the end the block adds its non-zero bins to the (B, R, 256)
// global counts with integer atomics. Integer atomics make the counts exact
// and the same in every run; the Pallas kernel's background-skip variant and
// its row strips are TPU scheduling and are not needed for that.
//
// The entry point returns the first non-zero CUDA error code of its set-up
// and launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;            // pixels per block
constexpr size_t kBudget = 96 * 1024;          // shared bytes a block may take
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void region_hist_kernel(const int32_t* __restrict__ lab,
                                   const uint8_t* __restrict__ img,
                                   unsigned* __restrict__ hist, long long HW,
                                   int R, int nb) {
  extern __shared__ unsigned bins[];  // (R, nb)
  const int frame = blockIdx.z;
  const int b0 = blockIdx.y * nb;  // first bin of this block
  const int n_bins = R * nb;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) bins[k] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(HW, start + kChunk);
  const int32_t* l = lab + static_cast<long long>(frame) * HW;
  const uint8_t* v = img + static_cast<long long>(frame) * HW;
  const int lane = threadIdx.x & 31;
  // The loop bounds are the same for every thread, so whole warps enter
  // each step and the ballot names the lanes that hold a pixel.
  for (long long i0 = start; i0 < end; i0 += blockDim.x) {
    const long long i = i0 + threadIdx.x;
    const bool in = i < end;
    const unsigned active = __ballot_sync(kFull, in);
    if (in) {
      const int r = l[i];
      const int c = static_cast<int>(v[i]) - b0;
      const int key = (r >= 0 && r < R && c >= 0 && c < nb) ? r * nb + c : -1;
      const unsigned peers = __match_any_sync(active, key);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[key], __popc(peers));
    }
  }
  __syncthreads();
  unsigned* h = hist + static_cast<long long>(frame) * R * 256;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const unsigned n = bins[k];
    if (n) atomicAdd(&h[(k / nb) * 256 + b0 + k % nb], n);
  }
}

}  // namespace

// lab: (B, H*W) int32; img: (B, H*W) uint8; hist: (B, R, 256) uint32, zeroed
// by the caller. All contiguous.
extern "C" int region_histogram_launch(const void* lab, const void* img,
                                       void* hist, int B, long long HW, int R,
                                       void* stream) {
  if (B <= 0 || HW <= 0) return 0;
  if (R <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int nb = 256;
  while (nb > 1 && static_cast<size_t>(R) * nb * sizeof(unsigned) > kBudget) nb /= 2;
  const size_t smem = static_cast<size_t>(R) * nb * sizeof(unsigned);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((HW + kChunk - 1) / kChunk), 256 / nb, B);
  region_hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lab), static_cast<const uint8_t*>(img),
      static_cast<unsigned*>(hist), HW, R, nb);
  return static_cast<int>(cudaGetLastError());
}
