// The grid route of the connected-component labelling (ops/label.py): the
// label fixpoint and the 8-connected vertical pass on frames whose bands the
// card cannot hold at once (ccl_banded.cu: a block a band, every band of a
// frame resident; on an H100 rows wider than 132 x 8192 = 1,081,344
// columns). The JAX `label` takes every frame with H * W < 2^30 - 1, so the
// widest rows it labels have about a thousand times more columns than a
// block walks.
//
// One entry point, bound to Python through a plain C launcher (ctypes),
// launching on the caller's stream, allocating nothing and returning the
// error code of the launch (0 = launched):
//
//   ccl_grid_launch   the fixpoint of ccl_fixpoint_launch (ccl.cu), or K4
//                     alone, on such frames.
//
// It replaces, on those rows, what ccl.cu replaces: the `jax.lax.while_loop`
// of `label` in maze_image_processing_pipeline_tpu/ops/label.py, K4
// (`vertical_pass_pallas`, attic/pallas_label.py) and K1 (`hpass_pallas`,
// maze_image_processing_pipeline_tpu/ops/pallas_scan.py).
//
// Design: one cooperative launch of as many blocks as the card holds at once,
// which synchronise the whole grid between the steps that depend on each
// other (cooperative groups' grid barrier; the launch is refused, never
// hung, where the blocks would not all be resident). Nothing is resident
// per band, so any width runs on any card:
// * K4 walks a frame's rows in order, the grid's threads strided over the
//   row's columns, with a grid barrier after each row: row r reads row r - 1
//   (and its diagonal neighbours) from device memory, where the whole grid
//   wrote it. At these widths a frame has at most 992 rows (H * W < 2^30),
//   so a pass costs at most about a thousand barriers a frame.
// * K1 runs on every row of every frame at once, in three grid steps: each
//   warp scans chunks of kGridChunk columns (staged in shared memory, as
//   ccl_banded.cu's wide K1) and notes the runs at the chunk's edges; one
//   thread a row and direction chains the chunks' edge runs (leftwards,
//   rightwards); the warps lower each chunk's edge runs to what crosses in.
// * The fixpoint: sweeps of K1 (the first sweep only: K1 is idempotent and
//   closes every sweep), K4 down, K4 up, K1. A frame's sweep changed
//   something when a pass lowered one of its labels; the pass then raises
//   the frame's `last` to the sweep (atomicMax: one atomic a block and
//   frame for K4, one a warp and chunk for K1). After a sweep every block
//   reads the same `last`s and the frames whose sweep changed nothing, or
//   that reached max_iters, stop and write their sweep count, as the
//   one-block route counts them. `last` only rises, so a block that reads it
//   while a faster one already runs the next sweep decides the same.
// There is no watchdog: a grid barrier waits only for blocks that are
// resident and running, never for a neighbour's slot.
//
// Reads of labels that other blocks wrote go through L2 (ld.global.cg).

#include <cooperative_groups.h>

#include "ccl_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGridThreads = 1024;
constexpr int kGridWarps = kGridThreads / kWarp;
constexpr int kGridChunk = 1024;                     // columns a warp of K1 stages at once
constexpr size_t kGridChunkBytes = 5 * kGridChunk;  // a warp's staged labels and mask bytes

// A chunk's edge runs (as ccl_banded.cu's ChunkSum).
struct ChunkSum {
  int head, tail;         // minimum of the run at the chunk's left and right edge (kInf: none)
  int first_bg, last_bg;  // the chunk's first and last background column (cw and -1: none)
  int pass;               // foreground throughout
  int left, right;        // minimum of the runs that cross in from the left and the right
  int pad;
};

struct GridArgs {
  const int32_t* src;  // labels read (the fixpoint: == dst)
  int32_t* dst;        // labels written
  const uint8_t* fg;
  int B, H, W;
  int conn;            // 1: 4-connected, 2: 8-connected
  int fixpoint;        // 1: the fixpoint; 0: K4 alone
  int reverse;         // K4 alone: bottom to top
  int max_iters;
  int32_t* sweeps;     // (B,) sweeps run (the fixpoint)
  int* last;           // (B,) the last sweep that changed the frame (the fixpoint)
  ChunkSum* sums;      // (B * H * chunks) K1's chunk summaries (the fixpoint)
};

// Lowers lab[from, to) to at most m, a warp's lanes strided over the span.
// Returns whether this lane changed a value.
__device__ __forceinline__ int lower_span(int32_t* lab, int from, int to, int m, int lane) {
  int changed = 0;
  if (m >= kInf) return 0;
  for (int x = from + lane; x < to; x += kWarp) {
    if (m < lab[x]) {
      lab[x] = m;
      changed = 1;
    }
  }
  return changed;
}

// A frame takes part in sweep `sweep` when its sweep before changed
// something (every frame takes part in the first).
__device__ __forceinline__ bool active(const GridArgs& a, int b, int sweep) {
  return !a.fixpoint || __ldcg(a.last + b) >= sweep - 1;
}

__device__ __forceinline__ void mark_changed(const GridArgs& a, int b, int sweep) {
  atomicMax(a.last + b, sweep);
}

// K1 over every row of the active frames, in place on dst; ends with a grid
// barrier.
__device__ void k1_grid(const GridArgs& a, cg::grid_group& grid, char* smem, int sweep) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long gwarp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long nwarps = static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  const int chunks = (a.W + kGridChunk - 1) / kGridChunk;
  const long long rows = static_cast<long long>(a.B) * a.H;
  const long long total = rows * chunks;
  const int seg = k1_seg(kGridChunk);
  int32_t* lab_s = reinterpret_cast<int32_t*>(smem + warp * kGridChunkBytes);
  uint8_t* fg_s = reinterpret_cast<uint8_t*>(lab_s + kGridChunk);

  // 1. Each chunk scanned alone; its edge runs noted.
  for (long long i = gwarp; i < total; i += nwarps) {
    const long long row = i / chunks;
    const int q = static_cast<int>(i % chunks);
    const int b = static_cast<int>(row / a.H);
    if (!active(a, b, sweep)) continue;
    const int c0 = q * kGridChunk, cw = min(kGridChunk, a.W - c0);
    int32_t* lab_r = a.dst + row * a.W + c0;
    const uint8_t* fg_r = a.fg + row * a.W + c0;
    int first = cw, lastbg = -1;
    for (int x = lane; x < cw; x += kWarp) {
      lab_s[x] = __ldcg(lab_r + x);
      const uint8_t f = fg_r[x];
      fg_s[x] = f;
      if (!f) {
        first = min(first, x);
        lastbg = x;
      }
    }
    first = __reduce_min_sync(kFull, first);
    lastbg = __reduce_max_sync(kFull, lastbg);
    __syncwarp();
    const bool changed = k1_row(lab_s, fg_s, cw, seg, lane);
    __syncwarp();
    for (int x = lane; x < cw; x += kWarp) lab_r[x] = lab_s[x];
    if (lane == 0) {
      ChunkSum& c = a.sums[i];
      c.head = fg_s[0] ? lab_s[0] : kInf;
      c.tail = fg_s[cw - 1] ? lab_s[cw - 1] : kInf;
      c.first_bg = first;
      c.last_bg = lastbg;
      c.pass = first == cw;
    }
    if (__any_sync(kFull, changed) && lane == 0) mark_changed(a, b, sweep);
    __syncwarp();
  }
  grid.sync();

  // 2. The chains of edge runs: a thread a row and direction.
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = tid; t < 2 * rows; t += nthreads) {
    const long long row = t >> 1;
    if (!active(a, static_cast<int>(row / a.H), sweep)) continue;
    ChunkSum* s = a.sums + row * chunks;
    int in = kInf;
    if ((t & 1) == 0) {
      for (int q = 0; q < chunks; ++q) {
        s[q].left = in;
        const int tail = __ldcg(&s[q].tail);
        in = __ldcg(&s[q].pass) ? min(in, tail) : tail;
      }
    } else {
      for (int q = chunks - 1; q >= 0; --q) {
        s[q].right = in;
        const int head = __ldcg(&s[q].head);
        in = __ldcg(&s[q].pass) ? min(in, head) : head;
      }
    }
  }
  grid.sync();

  // 3. Each chunk's edge runs lowered to what crosses in.
  for (long long i = gwarp; i < total; i += nwarps) {
    const long long row = i / chunks;
    const int q = static_cast<int>(i % chunks);
    const int b = static_cast<int>(row / a.H);
    if (!active(a, b, sweep)) continue;
    const ChunkSum* c = a.sums + i;
    const int left = __ldcg(&c->left), right = __ldcg(&c->right);
    const int first = __ldcg(&c->first_bg), lastbg = __ldcg(&c->last_bg);
    const int c0 = q * kGridChunk, cw = min(kGridChunk, a.W - c0);
    int32_t* o = a.dst + row * a.W + c0;
    int changed;
    if (__ldcg(&c->pass)) {
      changed = lower_span(o, 0, cw, min(left, right), lane);
    } else {
      changed = lower_span(o, 0, first, left, lane);
      changed |= lower_span(o, lastbg + 1, cw, right, lane);
    }
    if (__any_sync(kFull, changed) && lane == 0) mark_changed(a, b, sweep);
  }
  grid.sync();
}

// K4 over the active frames, one frame after another, a grid barrier after
// each row: src → dst (in place in the fixpoint).
__device__ void k4_grid(const GridArgs& a, cg::grid_group& grid, bool up, int sweep, int* flag) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool eight = a.conn == 2;
  for (int b = 0; b < a.B; ++b) {
    if (threadIdx.x == 0) *flag = active(a, b, sweep);
    __syncthreads();
    const bool on_frame = *flag != 0;
    __syncthreads();
    if (!on_frame) continue;  // the same for every block: `last` only rises
    const size_t base = static_cast<size_t>(b) * a.H * a.W;
    int changed = 0;
    for (int n = 0; n < a.H; ++n) {
      const int r = up ? a.H - 1 - n : n;
      const size_t off = base + static_cast<size_t>(r) * a.W;
      const int32_t* prev = n > 0 ? a.dst + base + static_cast<size_t>(up ? r + 1 : r - 1) * a.W : nullptr;
      for (long long c = tid; c < a.W; c += nthreads) {
        const int l = __ldcg(a.src + off + c);
        int m = kInf;
        if (prev != nullptr) {
          m = __ldcg(prev + c);
          if (eight) {
            if (c > 0) m = min(m, __ldcg(prev + c - 1));
            if (c + 1 < a.W) m = min(m, __ldcg(prev + c + 1));
          }
        }
        const int v = a.fg[off + c] ? min(l, m) : kInf;
        changed |= v != l;
        a.dst[off + c] = v;
      }
      grid.sync();
    }
    if (a.fixpoint) {
      if (__syncthreads_or(changed) && threadIdx.x == 0) mark_changed(a, b, sweep);
    }
  }
}

__global__ void __launch_bounds__(kGridThreads, 1) ccl_grid_kernel(GridArgs a) {
  extern __shared__ __align__(16) char smem_buf[];
  __shared__ int flag;
  cg::grid_group grid = cg::this_grid();
  if (!a.fixpoint) {
    k4_grid(a, grid, a.reverse != 0, 0, &flag);
    return;
  }
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = tid; b < a.B; b += nthreads) a.last[b] = 0;
  grid.sync();
  for (int sweep = 1;; ++sweep) {
    if (sweep == 1) k1_grid(a, grid, smem_buf, sweep);
    k4_grid(a, grid, false, sweep, &flag);
    k4_grid(a, grid, true, sweep, &flag);
    k1_grid(a, grid, smem_buf, sweep);
    // Every block reads the same `last`s; block 0 writes the sweep counts of
    // the frames that stop.
    int more = 0;
    for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
      const int last = __ldcg(a.last + b);
      if (last < sweep - 1) continue;  // stopped before
      if (last >= sweep && sweep < a.max_iters) {
        more = 1;
      } else if (blockIdx.x == 0) {
        a.sweeps[b] = sweep;
      }
    }
    if (!__syncthreads_or(more)) break;
  }
}

}  // namespace

// The fixpoint of ccl_fixpoint_launch (fixpoint = 1: lab in place, sweeps
// (B,) written) or K4 alone (fixpoint = 0: lab → out, reverse) on the grid
// route. ws: grid_workspace_bytes(B, H, W) bytes of scratch (the fixpoint;
// nothing is read from it before it is written). Returns
// cudaErrorCooperativeLaunchTooLarge where the card cannot hold one block.
extern "C" int ccl_grid_launch(const void* lab, const void* fg, void* out, void* sweeps, void* ws, int B, int H, int W,
                               int connectivity, int fixpoint, int reverse, int max_iters, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (connectivity != 1 && connectivity != 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_bytes = kGridWarps * kGridChunkBytes;
  cudaError_t e = cudaFuncSetAttribute(ccl_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ccl_grid_kernel, kGridThreads, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  GridArgs a{};
  a.src = static_cast<const int32_t*>(lab);
  a.dst = static_cast<int32_t*>(fixpoint ? const_cast<void*>(lab) : out);
  a.fg = static_cast<const uint8_t*>(fg);
  a.B = B;
  a.H = H;
  a.W = W;
  a.conn = connectivity;
  a.fixpoint = fixpoint;
  a.reverse = reverse;
  a.max_iters = max_iters;
  a.sweeps = static_cast<int32_t*>(sweeps);
  a.last = static_cast<int*>(ws);
  a.sums = reinterpret_cast<ChunkSum*>(static_cast<char*>(ws) + 32 * ((static_cast<size_t>(B) + 7) / 8));
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ccl_grid_kernel),
                                                      dim3(static_cast<unsigned>(per_sm * sms)), dim3(kGridThreads),
                                                      params, smem_bytes, static_cast<cudaStream_t>(stream)));
}
