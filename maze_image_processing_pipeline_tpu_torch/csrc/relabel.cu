// K8: small-object removal of the frame chain
// (ops/label.py:remove_small_objects), for Hopper.
//
// Replaces the Pallas TPU kernel `remove_small_objects_pallas` of
// attic/pallas_relabel.py (and the XLA `remove_small_objects` of
// maze_image_processing_pipeline_tpu/ops/label.py). For each frame, with R
// ids:
//
//   area[id]  = number of pixels with that id, for ids in (0, R);
//   keep[id]  = area[id] >= min_area, and id 0 is never kept;
//   new_ids   = cumsum(keep) * keep;
//   out       = new_ids[label] for labels in [0, R), else 0;
//   n         = keep.sum().
//
// Bound: device-memory bandwidth. The function reads the labels (4 B/px)
// and writes the result (4 B/px): 8 B/px, 84 MB at (8, 1024, 1280), 25 us
// at 3.35 TB/s. A frame's relabel needs the areas of the whole frame, the
// one dependency that splits the work in two.
//
// Two routes, chosen by ops/label.py:relabel_plan before the launch: the
// cluster route below wherever R's bins and table fit a block's shared
// memory (every path shape of the port), else the device-memory route
// (further down: bins and table in device memory, three launches).
//
// Design of the cluster route: one launch a call, one thread-block cluster
// a frame (the TPU kernel's two-phase grid over the same strips becomes two
// phases of one cluster, with the frame held in the cluster's shared memory
// between them).
// 1. Each of the cluster's `cs` blocks takes a share of the frame's pixels
//    (a multiple of 8), reads it once with 16-B loads (each warp issues its
//    next four loads before it counts the current four, so that loads stay
//    in flight: one 1024-thread block an SM), stages it into its shared
//    memory as uint8 where R <= 256, else uint16 (ids outside [0, R)
//    become 0, which is exact: they map to 0 and are not counted, and R's
//    bins fit a block, so R is far below 65536), and counts it into R
//    int32 bins of its own. Shared atomics are aggregated per warp
//    (__match_any_sync over the ids that fill a thread's 4-pixel vector:
//    plankton frames are runs of equal ids); id 0 is not counted (never
//    kept, and most of a frame).
// 2. cluster barrier; each block sums the cluster's `cs` bin arrays through
//    distributed shared memory (no atomics to device memory: the sums are
//    exact and deterministic) and builds the frame's new_ids table with its
//    own block-wide prefix sum over R. Rank 0 writes n. Each block then
//    arrives at a second cluster barrier, and waits on it only before it
//    exits, so that no block's bins vanish while another still reads them.
// 3. Each block relabels its staged share from shared memory and writes
//    int32 with 16-B stores.
// Where a share does not fit a block's shared memory (the dense haul's
// (8, 2048, 2560) frames: 5.2 MB of uint8 against 16 x 227 KB), the block
// stages the share's first `stage` pixels and reads the rest again from
// device memory in step 3: 12 B/px for that rest, still one launch. The
// plan (cluster size, staged pixels, shared bytes) is chosen in Python
// (ops/label.py:relabel_plan) from the card's limits that
// `relabel_capacity` reports: on an H100 SXM only 7 clusters of 16 blocks
// fit at once, so loki's 8 frames of 1024 x 1280 (1.3 MB of uint8 each)
// take clusters of 8, one wave of 64 SMs, each label read once. A cluster
// waits only on itself: clusters that do not fit at once run later, with
// no workspace, counter or co-residency across clusters. Rows that are not
// 16-B aligned (H*W not a multiple of 4, or an offset view) take the same
// steps one pixel at a time.
//
// The entry points return a CUDA error code (0 = launched / answered).

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-B loads a thread an iteration
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kScratchInts = kWarps + 8;  // the scan's warp totals and carry
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};
constexpr int kNumSizes = 5;

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) / 16 * 16; }

// Bytes a staged label takes: uint8 where R <= 256, else uint16.
__host__ __device__ inline int stage_bytes(int R) { return R <= 256 ? 1 : 2; }

// Byte offsets in a block's dynamic shared memory (mirrored by
// ops/label.py:relabel_fixed_bytes): R int32 bins, R uint16 new ids, the
// scan's scratch, then `stage` staged labels.
struct Layout {
  size_t table, scratch, stage, total;
};

__host__ __device__ inline Layout layout(int R, long long stage) {
  Layout l;
  l.table = r16(4 * static_cast<size_t>(R));
  l.scratch = l.table + r16(2 * static_cast<size_t>(R));
  l.stage = l.scratch + r16(4 * kScratchInts);
  l.total = l.stage + r16(static_cast<size_t>(stage_bytes(R)) * stage);
  return l;
}

struct Params {
  const int32_t* lab;
  int32_t* out;
  int32_t* n;
  long long HW;
  long long share;  // pixels a block (a multiple of 8)
  long long stage;  // pixels a block stages (a multiple of 8, <= share)
  int R;
  int min_area;
  int cs;  // blocks a cluster
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ int in_range(int v, int R) { return (v > 0 && v < R) ? v : 0; }

// Counts a thread's run of up to 4 pixels into `bins`. The warp's lanes
// whose 4 pixels share one id add them with one atomic per distinct id
// (`key` -1 marks a thread of mixed ids, which adds its own runs). Called
// by all lanes of a warp together.
__device__ __forceinline__ void count4(int32_t* bins, int a, int b, int c, int d) {
  const int key = (a == b && b == c && c == d) ? a : -1;
  if (!__any_sync(kFull, key != 0)) return;
  const unsigned peers = __match_any_sync(kFull, key);
  if (key > 0) {
    if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&bins[key], 4 * __popc(peers));
  } else if (key < 0) {
    int prev = a, run = 1;
    const int rest[3] = {b, c, d};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (rest[k] == prev) {
        ++run;
      } else {
        if (prev) atomicAdd(&bins[prev], run);
        prev = rest[k];
        run = 1;
      }
    }
    if (prev) atomicAdd(&bins[prev], run);
  }
}

// Inclusive prefix sum of x over the block, plus *carry; *carry becomes
// the total so far.
__device__ int block_scan(int x, int32_t* warp_sums, int32_t* carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int incl = x + (warp > 0 ? warp_sums[warp - 1] : 0) + *carry;
  __syncthreads();  // carry and warp_sums are read before they change
  if (threadIdx.x == kThreads - 1) *carry = incl;
  __syncthreads();
  return incl;
}

// Four staged labels (ids already in [0, R)) as one store.
__device__ __forceinline__ void stage4(uint8_t* p, int a, int b, int c, int d) {
  *reinterpret_cast<uchar4*>(p) = make_uchar4(a, b, c, d);
}
__device__ __forceinline__ void stage4(uint16_t* p, int a, int b, int c, int d) {
  *reinterpret_cast<ushort4*>(p) = make_ushort4(a, b, c, d);
}
__device__ __forceinline__ int4 relabel4(const uint8_t* p, const uint16_t* table) {
  const uchar4 s = *reinterpret_cast<const uchar4*>(p);
  return make_int4(table[s.x], table[s.y], table[s.z], table[s.w]);
}
__device__ __forceinline__ int4 relabel4(const uint16_t* p, const uint16_t* table) {
  const ushort4 s = *reinterpret_cast<const ushort4*>(p);
  return make_int4(table[s.x], table[s.y], table[s.z], table[s.w]);
}

// StageT: uint8_t where R <= 256, else uint16_t. kVec: the labels and the
// output are 16-B aligned and H*W is a multiple of 4, so every share is
// whole 4-pixel vectors.
template <typename StageT, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) relabel_cluster_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(p.R, p.stage);
  int32_t* bins = reinterpret_cast<int32_t*>(smem_raw);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem_raw + L.table);
  int32_t* scratch = reinterpret_cast<int32_t*>(smem_raw + L.scratch);
  StageT* staged = reinterpret_cast<StageT*>(smem_raw + L.stage);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long frame = blockIdx.x / p.cs;
  const int R = p.R;
  const int32_t* lab = p.lab + frame * p.HW;
  int32_t* out = p.out + frame * p.HW;
  const long long lo = min(p.HW, rank * p.share);
  const long long hi = min(p.HW, lo + p.share);
  const long long mid = min(hi, lo + p.stage);  // [lo, mid) staged, [mid, hi) read again in step 3
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < R; i += kThreads) bins[i] = 0;
  if (threadIdx.x == 0) scratch[kWarps] = 0;
  __syncthreads();

  // 1. Read the share once; stage [lo, mid); count. A warp takes 32 *
  // kUnroll consecutive vectors an iteration (a warp-uniform trip count:
  // its lanes call count4 together) and loads the next iteration's before
  // it counts these.
  if (kVec) {
    const int4* lab4 = reinterpret_cast<const int4*>(lab);
    const long long v0 = lo >> 2, v1 = hi >> 2, vmid = mid >> 2;
    constexpr long long kStride = kThreads * kUnroll;
    long long c = v0 + warp * 32 * kUnroll;
    int4 next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = c + u * 32 + lane;
      next[u] = j < v1 ? __ldg(lab4 + j) : make_int4(0, 0, 0, 0);
    }
    for (; c < v1; c += kStride) {
      int4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        q[u] = next[u];
        const long long j = c + kStride + u * 32 + lane;
        next[u] = j < v1 ? __ldg(lab4 + j) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = c + u * 32 + lane;
        const int a = in_range(q[u].x, R), b = in_range(q[u].y, R);
        const int e = in_range(q[u].z, R), d = in_range(q[u].w, R);
        if (j < vmid) stage4(staged + 4 * (j - v0), a, b, e, d);
        count4(bins, a, b, e, d);
      }
    }
  } else {
    for (long long w = lo + warp * 32; w < hi; w += kThreads) {
      const long long i = w + lane;
      const int v = i < hi ? in_range(lab[i], R) : 0;
      if (i < mid) staged[i - lo] = static_cast<StageT>(v);
      if (__any_sync(kFull, v != 0)) {
        const unsigned peers = __match_any_sync(kFull, v);
        if (v > 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[v], __popc(peers));
      }
    }
  }
  cluster.sync();

  // 2. The frame's areas from the cluster's bins, the keep table, n.
  int32_t* carry = scratch + kWarps;
  for (int base = 0; base < R; base += kThreads) {
    const int i = base + threadIdx.x;
    int area = 0;
    if (i < R) {
#pragma unroll 4
      for (int r = 0; r < p.cs; ++r) area += cluster.map_shared_rank(bins, r)[i];
    }
    const int keep = (i > 0 && i < R && area >= p.min_area) ? 1 : 0;
    const int incl = block_scan(keep, scratch, carry);
    if (i < R) table[i] = static_cast<uint16_t>(keep ? incl : 0);
  }
  cluster_arrive();  // this block has read the cluster's bins
  if (rank == 0 && threadIdx.x == 0) p.n[frame] = *carry;
  __syncthreads();  // the table is whole

  // 3. Relabel: the staged part from shared memory, the rest read again.
  if (kVec) {
    int4* out4 = reinterpret_cast<int4*>(out);
    const int4* lab4 = reinterpret_cast<const int4*>(lab);
    const long long v0 = lo >> 2, v1 = hi >> 2, vmid = mid >> 2;
    for (long long j = v0 + threadIdx.x; j < vmid; j += kThreads) out4[j] = relabel4(staged + 4 * (j - v0), table);
    for (long long j = vmid + threadIdx.x; j < v1; j += kThreads) {
      const int4 q = __ldg(lab4 + j);
      out4[j] = make_int4(table[in_range(q.x, R)], table[in_range(q.y, R)], table[in_range(q.z, R)],
                          table[in_range(q.w, R)]);
    }
  } else {
    for (long long i = lo + threadIdx.x; i < mid; i += kThreads) out[i] = table[staged[i - lo]];
    for (long long i = mid + threadIdx.x; i < hi; i += kThreads) out[i] = table[in_range(lab[i], R)];
  }
  cluster_wait();  // no block leaves while another reads its bins
}

// ---- the device-memory route ------------------------------------------------
//
// Where R's bins and table do not fit a block's shared memory (R above
// about 38,700 on an H100) or the ids pass uint16 (R > 65536), the bins and
// the table live in device memory as (B, R) int32, in three launches after
// the launcher's memset of the bins, with no host synchronisation:
// 1. count_global_kernel: blocks take chunks of a frame's pixels and count
//    them into the frame's bins with device-memory atomics, aggregated per
//    warp as in step 1 above (count4; id 0 and ids outside [0, R) are not
//    counted);
// 2. scan_global_kernel: a block a frame turns its bins, in place, into the
//    table cumsum(keep) * keep and writes n, in rounds of 1024 x kScanPer
//    bins staged in shared memory (coalesced reads and writes): each thread
//    counts the kept ids of its kScanPer consecutive bins, the block-wide
//    scan of step 2 (with its carry) gives each thread its first new id, and
//    it writes its bins' ids;
// 3. relabel_global_kernel: blocks take the same chunks and write
//    table[label] (0 outside [0, R)), the table read through L2.
// Bound: device memory. It reads the labels twice (12 B/px with the
// output: the function's own 8 B/px and 4 more) and moves the (B, R) bins
// about five times (the memset, the count's atomics in L2, the scan's read
// and write, the gather's reads): about 20 B an id.

constexpr long long kChunk = 32768;  // pixels a block of steps 1 and 3
constexpr int kScanPer = 8;          // consecutive bins a thread of step 2 takes a round

// The chunk of frame blockIdx.x / chunks that this block takes: [lo, hi).
__device__ __forceinline__ void chunk_of(long long HW, int chunks, long long& f, long long& lo, long long& hi) {
  f = blockIdx.x / chunks;
  lo = min(HW, static_cast<long long>(blockIdx.x % chunks) * kChunk);
  hi = min(HW, lo + kChunk);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) count_global_kernel(const int32_t* lab, int32_t* bins, long long HW,
                                                                 int chunks, int R) {
  long long f, lo, hi;
  chunk_of(HW, chunks, f, lo, hi);
  const int32_t* l = lab + f * HW;
  int32_t* b = bins + f * R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (kVec) {  // whole 4-pixel vectors (kChunk and HW multiples of 4); warp-uniform trip counts
    const int4* l4 = reinterpret_cast<const int4*>(l);
    for (long long w = (lo >> 2) + warp * 32; w < (hi >> 2); w += kThreads) {
      const long long j = w + lane;
      const int4 q = j < (hi >> 2) ? __ldg(l4 + j) : make_int4(0, 0, 0, 0);
      count4(b, in_range(q.x, R), in_range(q.y, R), in_range(q.z, R), in_range(q.w, R));
    }
  } else {
    for (long long w = lo + warp * 32; w < hi; w += kThreads) {
      const long long i = w + lane;
      const int v = i < hi ? in_range(l[i], R) : 0;
      if (__any_sync(kFull, v != 0)) {
        const unsigned peers = __match_any_sync(kFull, v);
        if (v > 0 && lane == __ffs(peers) - 1) atomicAdd(&b[v], __popc(peers));
      }
    }
  }
}

// Bin j of a round's tile in shared memory, padded a word every 32 so that
// a thread's kScanPer consecutive bins fall in distinct banks.
__device__ __forceinline__ int tile_slot(int j) { return j + j / 32; }

__global__ void __launch_bounds__(kThreads) scan_global_kernel(int32_t* bins, int32_t* n, int R, int min_area) {
  constexpr int kRound = kThreads * kScanPer;
  __shared__ int32_t scratch[kScratchInts];
  __shared__ int32_t tile[kRound + kRound / 32];
  int32_t* table = bins + static_cast<long long>(blockIdx.x) * R;
  int32_t* carry = scratch + kWarps;
  if (threadIdx.x == 0) *carry = 0;
  __syncthreads();
  for (long long base = 0; base < R; base += kRound) {
    for (int j = threadIdx.x; j < kRound; j += kThreads) tile[tile_slot(j)] = base + j < R ? table[base + j] : 0;
    __syncthreads();
    const int first = threadIdx.x * kScanPer;
    int keep[kScanPer];
    int kept = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const long long i = base + first + k;
      keep[k] = (i > 0 && i < R && tile[tile_slot(first + k)] >= min_area) ? 1 : 0;
      kept += keep[k];
    }
    int id = block_scan(kept, scratch, carry) - kept;  // kept ids before this thread's; the tile is read
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      id += keep[k];
      tile[tile_slot(first + k)] = keep[k] ? id : 0;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kRound && base + j < R; j += kThreads) table[base + j] = tile[tile_slot(j)];
    __syncthreads();  // the tile is written out before the next round
  }
  if (threadIdx.x == 0) n[blockIdx.x] = *carry;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) relabel_global_kernel(const int32_t* lab, int32_t* out,
                                                                   const int32_t* table, long long HW, int chunks,
                                                                   int R) {
  long long f, lo, hi;
  chunk_of(HW, chunks, f, lo, hi);
  const int32_t* l = lab + f * HW;
  int32_t* o = out + f * HW;
  const int32_t* t = table + f * R;
  if (kVec) {
    const int4* l4 = reinterpret_cast<const int4*>(l);
    int4* o4 = reinterpret_cast<int4*>(o);
    for (long long j = (lo >> 2) + threadIdx.x; j < (hi >> 2); j += kThreads) {
      const int4 q = __ldg(l4 + j);
      o4[j] = make_int4(__ldg(t + in_range(q.x, R)), __ldg(t + in_range(q.y, R)), __ldg(t + in_range(q.z, R)),
                        __ldg(t + in_range(q.w, R)));
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) o[i] = __ldg(t + in_range(l[i], R));
  }
}

struct Info {
  int smem;  // dynamic shared bytes a block can take
  int sms;
  int active[kNumSizes];  // clusters of each kClusterSizes size co-resident at `smem` bytes a block
};

// The card's limits, asked once per device; sets both kernels' attributes
// (the largest dynamic shared memory, cluster sizes beyond 8).
int info(Info* out) {
  static std::mutex mu;
  static Info cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  Info& c = cache[dev];
  if (c.smem == 0) {
    int optin = 0, sms = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    Info in{optin / 16 * 16, sms, {}};
    const void* kernels[] = {reinterpret_cast<const void*>(relabel_cluster_kernel<uint8_t, true>),
                             reinterpret_cast<const void*>(relabel_cluster_kernel<uint8_t, false>),
                             reinterpret_cast<const void*>(relabel_cluster_kernel<uint16_t, true>),
                             reinterpret_cast<const void*>(relabel_cluster_kernel<uint16_t, false>)};
    for (const void* k : kernels) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
      if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    for (int s = 0; s < kNumSizes; ++s) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kClusterSizes[s];
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(kClusterSizes[s]);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = in.smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      e = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(relabel_cluster_kernel<uint16_t, true>),
                                         &cfg);
      if (e != cudaSuccess) {
        cudaGetLastError();  // a size the card refuses: no clusters of it
        n = 0;
      }
      in.active[s] = n;
    }
    c = in;
  }
  *out = c;
  return 0;
}

}  // namespace

// out[0]: dynamic shared bytes a block can take; out[1]: SMs; out[2 + s]:
// clusters of 1, 2, 4, 8, 16 blocks of that many bytes co-resident.
extern "C" int relabel_capacity(int* out) {
  Info in{};
  if (const int err = info(&in)) return err;
  out[0] = in.smem;
  out[1] = in.sms;
  for (int s = 0; s < kNumSizes; ++s) out[2 + s] = in.active[s];
  return 0;
}

// lab, out: (B, H*W) int32, contiguous; n: (B,) int32. The plan
// (ops/label.py:relabel_plan): clusters of `cs` blocks, `share` pixels a
// block (a multiple of 8, cs * share >= H*W), the first `stage` of them
// staged (a multiple of 8; stage == share: each label read once), as uint8
// where R <= 256, else uint16.
extern "C" int remove_small_objects_launch(const void* lab, void* out, void* n, int B, long long HW, int R,
                                           int min_area, int cs, long long share, long long stage,
                                           void* stream) {
  if (B <= 0) return 0;
  Info in{};
  if (const int err = info(&in)) return err;
  const Layout L = layout(R, stage);
  const bool size_ok = std::find(kClusterSizes, kClusterSizes + kNumSizes, cs) != kClusterSizes + kNumSizes;
  if (R < 1 || R > 65536 || HW < 0 || !size_ok || share < 0 || share % 8 || stage < 0 || stage % 8 ||
      stage > share || share * cs < HW || L.total > static_cast<size_t>(in.smem) ||
      static_cast<long long>(B) * cs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const int32_t*>(lab), static_cast<int32_t*>(out), static_cast<int32_t*>(n), HW, share,
           stage, R, min_area, cs};
  const bool vec = HW % 4 == 0 && reinterpret_cast<uintptr_t>(lab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(B * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (stage_bytes(R) == 1) {
    e = vec ? cudaLaunchKernelEx(&cfg, relabel_cluster_kernel<uint8_t, true>, p)
            : cudaLaunchKernelEx(&cfg, relabel_cluster_kernel<uint8_t, false>, p);
  } else {
    e = vec ? cudaLaunchKernelEx(&cfg, relabel_cluster_kernel<uint16_t, true>, p)
            : cudaLaunchKernelEx(&cfg, relabel_cluster_kernel<uint16_t, false>, p);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The device-memory route (the plan's where R's bins and table do not fit
// a block, or R > 65536; refused elsewhere): lab, out (B, H*W) int32,
// contiguous; n (B,) int32; bins (B, R) int32 scratch, zeroed here.
extern "C" int remove_small_objects_global_launch(const void* lab, void* out, void* n, void* bins, int B,
                                                  long long HW, int R, int min_area, void* stream) {
  if (B <= 0) return 0;
  Info in{};
  if (const int err = info(&in)) return err;
  if (R < 1 || HW < 0 || bins == nullptr || (R <= 65536 && layout(R, 0).total <= static_cast<size_t>(in.smem)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = std::max(1LL, (HW + kChunk - 1) / kChunk);
  if (static_cast<long long>(B) * chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const int32_t*>(lab);
  auto* o = static_cast<int32_t*>(out);
  auto* b = static_cast<int32_t*>(bins);
  const bool vec = HW % 4 == 0 && reinterpret_cast<uintptr_t>(lab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(B * chunks);
  cudaError_t e = cudaMemsetAsync(bins, 0, static_cast<size_t>(B) * R * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec) {
    count_global_kernel<true><<<grid, kThreads, 0, st>>>(l, b, HW, static_cast<int>(chunks), R);
  } else {
    count_global_kernel<false><<<grid, kThreads, 0, st>>>(l, b, HW, static_cast<int>(chunks), R);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  scan_global_kernel<<<static_cast<unsigned>(B), kThreads, 0, st>>>(b, static_cast<int32_t*>(n), R, min_area);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (vec) {
    relabel_global_kernel<true><<<grid, kThreads, 0, st>>>(l, o, b, HW, static_cast<int>(chunks), R);
  } else {
    relabel_global_kernel<false><<<grid, kThreads, 0, st>>>(l, o, b, HW, static_cast<int>(chunks), R);
  }
  return static_cast<int>(cudaGetLastError());
}
