// Shared-memory staging for the port's CUDA kernels: mbarriers and
// asynchronous global-to-shared copies (cp.async, 16 B where a 16-B block
// lies in the tensor, 4-B words or single bytes at a ragged edge). Used by
// ccl.cu (the label walk's ring), region_measure.cu (the measurement's
// strips) and group_norm.cu (the shares of a normalisation unit).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCopyWarp = 32;

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// ---- barriers and copies ---------------------------------------------------

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar, unsigned count) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.release.cta.shared::cta.b64 st, [%0], %1;\n}" ::"r"(smem(bar)),
      "r"(count)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// The arrive-on of `bar` fires when this thread's earlier cp.async copies
// have landed (the pending count is raised now and lowered then).
__device__ __forceinline__ void bar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)), "l"(src) : "memory");
}

// One warp copies the bytes [src, src + n) into `dst` (16-B aligned) so that
// dst[a - floor16(src)] holds the byte at address a: whole 16-B blocks, the
// neighbouring bytes of the first and last block included, as long as they
// lie in the tensor [t0, t1). A block cut by the tensor's edge goes as 4-B
// words where whole, and as single bytes (plain loads) where not.
__device__ __forceinline__ void copy_span(char* dst, const char* src, size_t n, const char* t0,
                                          const char* t1, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t e = (reinterpret_cast<uintptr_t>(src) + n + 15) & ~uintptr_t(15);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(t0), hi = reinterpret_cast<uintptr_t>(t1);
  if (a >= lo && e <= hi) {  // the rule: every block lies in the tensor
    const int blocks = static_cast<int>((e - a) / 16);
    for (int k = lane; k < blocks; k += kCopyWarp) copy16(dst + 16 * k, reinterpret_cast<const void*>(a + 16 * k));
    return;
  }
  for (uintptr_t g = a + 16 * lane; g < e; g += 16 * kCopyWarp) {
    char* d = dst + (g - a);
    if (g >= lo && g + 16 <= hi) {
      copy16(d, reinterpret_cast<const void*>(g));
      continue;
    }
    for (uintptr_t w = g; w < g + 16; w += 4) {
      if (w >= lo && w + 4 <= hi) {
        copy4(d + (w - g), reinterpret_cast<const void*>(w));
        continue;
      }
      for (uintptr_t x = w; x < w + 4; ++x) {
        if (x >= lo && x < hi) {
          d[x - g] = *reinterpret_cast<const char*>(x);
        }
      }
    }
  }
}

// The slot position of the element at `p`: its offset in its 16-B block.
template <typename T>
__device__ __forceinline__ T* in_slot(char* slot, const void* p) {
  return reinterpret_cast<T*>(slot + (reinterpret_cast<uintptr_t>(p) & 15));
}

// Waits until this thread's cp.async copies have landed; a block barrier
// after it makes every thread's copies visible to the block.
__device__ __forceinline__ void copies_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

}  // namespace
