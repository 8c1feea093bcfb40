// K9: the layout anchor of the frame-chain perf lab
// (tools/perf_lab.py:anchor of the port), for Hopper.
//
// Replaces the Pallas TPU kernel `anchor` of tools/perf_lab.py: an identity
// copy of a (B, H, W) mask, one (1, H, W) VMEM block per frame, which pins
// the standard layout between the morphology chain and `label`. Here it
// reads a (B, H, W) tensor of any strides and writes a new contiguous
// (row-major) tensor with the same values: out[b, h, w] = in[b, h, w].
//
// Bound: device-memory bandwidth. The function reads every element once and
// writes it once: 2 bytes per byte of the mask, 16.8 MB for an (8, 1024,
// 1024) bool mask, 5.0 us at 3.35 TB/s, below a launch's latency.
//
// Design, one launch:
// * contiguous input with both pointers 16-byte aligned: copy_vec_kernel
//   moves 16-byte vectors (uint4), grid-strided, neighbouring threads on
//   neighbouring vectors; the bytes past the last whole vector go one byte
//   a thread;
// * otherwise: copy_strided_kernel<T> with T of the element's size (1, 2, 4
//   or 8 bytes), one element a thread in output order (the writes
//   coalesce; the reads follow the input's strides).
// Nothing is allocated here: the wrapper passes the output.
//
// The entry point returns cudaGetLastError() of its launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

long long blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__global__ void copy_vec_kernel(const uint4* __restrict__ in,
                                uint4* __restrict__ out, long long n_vec,
                                const uint8_t* __restrict__ in_tail,
                                uint8_t* __restrict__ out_tail, int n_tail) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < n_vec; i += stride) out[i] = in[i];
  if (first < n_tail) out_tail[first] = in_tail[first];
}

template <typename T>
__global__ void copy_strided_kernel(const T* __restrict__ in,
                                    T* __restrict__ out, long long n,
                                    long long H, long long W, long long sb,
                                    long long sh, long long sw) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long HW = H * W;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long b = i / HW;
    const long long r = i - b * HW;
    const long long h = r / W;
    const long long w = r - h * W;
    out[i] = in[b * sb + h * sh + w * sw];
  }
}

template <typename T>
int launch_strided(const void* in, void* out, long long n, long long H,
                   long long W, long long sb, long long sh, long long sw,
                   cudaStream_t s) {
  copy_strided_kernel<T><<<static_cast<unsigned>(blocks_for(n)), kThreads, 0, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, H, W, sb, sh, sw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (B, H, W) with strides (sb, sh, sw) in elements of elem_size bytes;
// out: (B, H, W) contiguous. vec != 0 promises a contiguous input and both
// pointers 16-byte aligned.
extern "C" int anchor_launch(const void* in, void* out, long long B,
                             long long H, long long W, long long sb,
                             long long sh, long long sw, int elem_size,
                             int vec, void* stream) {
  const long long n = B * H * W;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const long long nbytes = n * elem_size;
    const long long n_vec = nbytes / 16;
    const int n_tail = static_cast<int>(nbytes - n_vec * 16);
    const long long blocks = blocks_for(n_vec > n_tail ? n_vec : n_tail);
    copy_vec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), n_vec,
        static_cast<const uint8_t*>(in) + n_vec * 16,
        static_cast<uint8_t*>(out) + n_vec * 16, n_tail);
    return static_cast<int>(cudaGetLastError());
  }
  switch (elem_size) {
    case 1: return launch_strided<uint8_t>(in, out, n, H, W, sb, sh, sw, s);
    case 2: return launch_strided<uint16_t>(in, out, n, H, W, sb, sh, sw, s);
    case 4: return launch_strided<uint32_t>(in, out, n, H, W, sb, sh, sw, s);
    case 8: return launch_strided<uint64_t>(in, out, n, H, W, sb, sh, sw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
