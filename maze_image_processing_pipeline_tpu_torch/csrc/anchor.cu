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
// Design, one launch, three routes:
// * contiguous input with both pointers 16-byte aligned (copy_vec_kernel):
//   each thread issues kVecs 16-byte loads (read-only, not kept in L1)
//   before its kVecs stores (streaming), so that a warp keeps kVecs * 512
//   bytes in flight; neighbouring threads take neighbouring vectors. The
//   bytes past the last whole vector go one byte a thread.
// * the transposed view, whose stride-1 axis is h (transpose_kernel): a
//   block moves a tile of the frame through shared memory, read along h and
//   written along w, so both sides coalesce. A tile is 32 x 32 words: for
//   1-byte elements 128 h by 32 w, read and written four bytes at a time
//   (a word of four h, then a word of four w gathered from the tile), for
//   wider elements 32 x 32 elements. Tile rows are padded by one word, so
//   neither the reads nor the gathers meet in a bank.
// * any other strides (copy_strided_kernel<T>, T of the element's size):
//   one element a thread in output order (the writes coalesce; the reads
//   follow the input's strides).
// Nothing is allocated here: the wrapper passes the output.
//
// The entry point returns cudaGetLastError() of its launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-byte vectors a thread of copy_vec_kernel has in flight
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kTile = 32;     // words a side of a transpose tile
constexpr int kTileRows = 8;  // thread rows of a transpose block (kTile x kTileRows threads)

long long blocks_for(long long n, long long per_block) {
  const long long b = (n + per_block - 1) / per_block;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// kTail: the bytes past the last whole vector, one a thread (compiled only
// into the tail's instantiation: with the tail's code the kernel timed ~1 %
// slower at (8, 2048, 2560)).
template <bool kTail>
__global__ void copy_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, long long n_vec,
                                const uint8_t* __restrict__ in_tail, uint8_t* __restrict__ out_tail, int n_tail) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * kVecs;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x * kVecs + threadIdx.x;
  for (long long base = first; base < n_vec; base += step) {
    uint4 v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < n_vec) v[k] = load_stream(in + i);
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < n_vec) store_stream(out + i, v[k]);
    }
  }
  if constexpr (kTail) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t < n_tail) out_tail[t] = in_tail[t];
  }
}

// 1-byte elements of the transposed view: in[b * sb + h + w * sw] (h the
// stride-1 axis). A tile is 128 h by 32 w. words: the input's words, and
// the output's rows, may be read and written as 4-byte words wherever a
// word lies whole in the frame (the wrapper checks the alignment).
template <bool kWords>
__global__ void __launch_bounds__(kTile * kTileRows) transpose_bytes_kernel(const uint8_t* __restrict__ in,
                                                                            uint8_t* __restrict__ out, int H, int W,
                                                                            long long sb, long long sw) {
  __shared__ uint32_t tile[kTile][kTile + 1];  // [w][h / 4], a byte of h each
  const int tiles_h = (H + 4 * kTile - 1) / (4 * kTile);
  const int tiles_w = (W + kTile - 1) / kTile;
  const long long t = blockIdx.x;
  const int b = static_cast<int>(t / (static_cast<long long>(tiles_h) * tiles_w));
  const int rest = static_cast<int>(t % (static_cast<long long>(tiles_h) * tiles_w));
  const int h0 = (rest / tiles_w) * 4 * kTile, w0 = (rest % tiles_w) * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const uint8_t* src = in + b * sb;

  // Read: warp ty takes columns w0 + ty, + 8, ...; lane tx four bytes of h.
  const int h = h0 + 4 * tx;
  for (int j = ty; j < kTile; j += kTileRows) {
    const int w = w0 + j;
    uint32_t v = 0;
    if (w < W) {
      const uint8_t* p = src + h + w * sw;
      if (kWords && h + 3 < H) {
        v = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int k = 0; k < 4; ++k) v |= h + k < H ? static_cast<uint32_t>(p[k]) << (8 * k) : 0u;
      }
    }
    tile[j][tx] = v;
  }
  __syncthreads();

  // Write: eight threads a row of h, each four bytes of w gathered from
  // four tile rows; a warp writes four rows of 32 bytes.
  const int q = threadIdx.x % 8, r = threadIdx.x / 8;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&tile[0][0]);
  for (int i = r; i < 4 * kTile; i += kTile * kTileRows / 8) {
    const int hh = h0 + i;
    if (hh >= H) break;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) v |= static_cast<uint32_t>(bytes[(4 * q + k) * 4 * (kTile + 1) + i]) << (8 * k);
    const int w = w0 + 4 * q;
    uint8_t* p = out + (static_cast<long long>(b) * H + hh) * W + w;
    if (kWords && w + 3 < W) {
      *reinterpret_cast<uint32_t*>(p) = v;
    } else {
      for (int k = 0; k < 4 && w + k < W; ++k) p[k] = static_cast<uint8_t>(v >> (8 * k));
    }
  }
}

// Wider elements of the transposed view: 32 x 32-element tiles.
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows) transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                                      int H, int W, long long sb, long long sw) {
  __shared__ T tile[kTile][kTile + 1];  // [w][h]
  const int tiles_h = (H + kTile - 1) / kTile;
  const int tiles_w = (W + kTile - 1) / kTile;
  const long long t = blockIdx.x;
  const int b = static_cast<int>(t / (static_cast<long long>(tiles_h) * tiles_w));
  const int rest = static_cast<int>(t % (static_cast<long long>(tiles_h) * tiles_w));
  const int h0 = (rest / tiles_w) * kTile, w0 = (rest % tiles_w) * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const T* src = in + b * sb;
  for (int j = ty; j < kTile; j += kTileRows) {
    if (h0 + tx < H && w0 + j < W) tile[j][tx] = src[h0 + tx + (w0 + j) * sw];
  }
  __syncthreads();
  for (int i = ty; i < kTile; i += kTileRows) {
    if (h0 + i < H && w0 + tx < W) out[(static_cast<long long>(b) * H + h0 + i) * W + w0 + tx] = tile[tx][i];
  }
}

template <typename T>
__global__ void copy_strided_kernel(const T* __restrict__ in, T* __restrict__ out, long long n, long long H,
                                    long long W, long long sb, long long sh, long long sw) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long HW = H * W;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long b = i / HW;
    const long long r = i - b * HW;
    const long long h = r / W;
    const long long w = r - h * W;
    out[i] = in[b * sb + h * sh + w * sw];
  }
}

template <typename T>
int launch_strided(const void* in, void* out, long long B, long long H, long long W, long long sb, long long sh,
                   long long sw, cudaStream_t s) {
  const long long n = B * H * W;
  if (sh == 1 && sw != 1 && H <= INT32_MAX && W <= INT32_MAX) {
    const long long tiles = B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
    if (tiles > UINT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    transpose_kernel<T><<<static_cast<unsigned>(tiles), kTile * kTileRows, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), static_cast<int>(H), static_cast<int>(W), sb, sw);
  } else {
    copy_strided_kernel<T><<<static_cast<unsigned>(blocks_for(n, kThreads)), kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n, H, W, sb, sh, sw);
  }
  return static_cast<int>(cudaGetLastError());
}

template <>
int launch_strided<uint8_t>(const void* in, void* out, long long B, long long H, long long W, long long sb,
                            long long sh, long long sw, cudaStream_t s) {
  if (sh != 1 || sw == 1 || H > INT32_MAX || W > INT32_MAX) {
    const long long n = B * H * W;
    copy_strided_kernel<uint8_t><<<static_cast<unsigned>(blocks_for(n, kThreads)), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, H, W, sb, sh, sw);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = B * ((H + 4 * kTile - 1) / (4 * kTile)) * ((W + kTile - 1) / kTile);
  if (tiles > UINT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // Words where every word the tiles touch is 4-byte aligned: the input's
  // base, frame and column strides, the output's base and rows.
  const bool words = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 4 == 0) &&
                     sb % 4 == 0 && sw % 4 == 0 && W % 4 == 0;
  const int h = static_cast<int>(H), w = static_cast<int>(W);
  auto src = static_cast<const uint8_t*>(in);
  auto dst = static_cast<uint8_t*>(out);
  if (words) {
    transpose_bytes_kernel<true><<<static_cast<unsigned>(tiles), kTile * kTileRows, 0, s>>>(src, dst, h, w, sb, sw);
  } else {
    transpose_bytes_kernel<false><<<static_cast<unsigned>(tiles), kTile * kTileRows, 0, s>>>(src, dst, h, w, sb, sw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (B, H, W) with strides (sb, sh, sw) in elements of elem_size bytes;
// out: (B, H, W) contiguous. vec != 0 promises a contiguous input and both
// pointers 16-byte aligned.
extern "C" int anchor_launch(const void* in, void* out, long long B, long long H, long long W, long long sb,
                             long long sh, long long sw, int elem_size, int vec, void* stream) {
  const long long n = B * H * W;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const long long nbytes = n * elem_size;
    const long long n_vec = nbytes / 16;
    const int n_tail = static_cast<int>(nbytes - n_vec * 16);
    const long long blocks = blocks_for(n_vec > n_tail ? n_vec : n_tail, static_cast<long long>(kThreads) * kVecs);
    auto src = static_cast<const uint4*>(in);
    auto dst = static_cast<uint4*>(out);
    auto src_tail = static_cast<const uint8_t*>(in) + n_vec * 16;
    auto dst_tail = static_cast<uint8_t*>(out) + n_vec * 16;
    if (n_tail) {
      copy_vec_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(src, dst, n_vec, src_tail, dst_tail, n_tail);
    } else {
      copy_vec_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(src, dst, n_vec, src_tail, dst_tail, 0);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (elem_size) {
    case 1: return launch_strided<uint8_t>(in, out, B, H, W, sb, sh, sw, s);
    case 2: return launch_strided<uint16_t>(in, out, B, H, W, sb, sh, sw, s);
    case 4: return launch_strided<uint32_t>(in, out, B, H, W, sb, sh, sw, s);
    case 8: return launch_strided<uint64_t>(in, out, B, H, W, sb, sh, sw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
