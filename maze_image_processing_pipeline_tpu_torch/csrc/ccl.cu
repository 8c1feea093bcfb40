// The connected-component labelling (ops/label.py, ops/row_scan.py) for
// Hopper: its horizontal pass (K1), its vertical pass (K4), and the whole
// label fixpoint of both in one launch.
//
// Three entry points, each bound to Python through a plain C launcher
// (ctypes); each launches on the caller's stream, allocates nothing and
// returns the cudaGetLastError() code of the launch (0 = launched):
//
//   hpass_launch          K1 alone: a warp per row.
//   vertical_pass_launch  K4 alone: one pass of the column walk.
//   ccl_fixpoint_launch   sweeps of K1, K4 down, K4 up, K1 until no pixel of
//                         the frame changes or max_iters sweeps have run,
//                         in place, one block per frame.
//
// Rows wider than a block walks (8192 columns; 46000 for K1 alone) take the
// banded route of ccl_banded.cu. Both files share ccl_rows.cuh: K1's row
// function, the ring and its plan.
//
// K1 replaces the Pallas TPU kernel `_hpass_kernel` of
// maze_image_processing_pipeline_tpu/ops/pallas_scan.py (`hpass_pallas`);
// K4 replaces `vertical_pass_pallas` of attic/pallas_label.py (and the strip
// walk `_vertical_pass` of maze_image_processing_pipeline_tpu/ops/label.py);
// the fixpoint replaces the `jax.lax.while_loop` of `label` in that module,
// whose body runs both.
//
// K1: every foreground pixel receives the minimum label of its horizontal
// run; background receives kInf. K4, for each frame, rows in order (top to
// bottom, or bottom to top):
//
//   carry = kInf before the first row;
//   carry[c] = fg[r, c] ? min(lab[r, c], N(carry)[c]) : kInf;
//   out[r, :] = carry,
//
// where N(carry) is carry itself for 4-connectivity and the minimum over
// columns c-1, c, c+1 (kInf beyond the edges) for 8-connectivity.
//
// Bound. Each pass reads the labels (4 B) and the mask (1 B) and writes the
// labels (4 B): 9 B/px, a handful of integer operations a pixel. A fixpoint
// call must at least read lab0 and fg and write the labels once. But K4's
// row r depends on row r-1, so a frame is H dependent steps: latency, not
// bytes, bounds the walk, and for 8-connectivity a frame cannot be split
// into independent column bands.
//
// Design.
// * K1's row function (`k1_row`) runs on a row held in shared memory, by one
//   warp, in place: each lane owns a contiguous segment of an odd number of
//   elements (so the 32 lanes hit 32 different banks), scans it forward and
//   back, and one segmented shuffle scan each way carries the runs that
//   cross segments. The row is read once and written once: the forward
//   result never leaves the chip.
// * The walk (`walk_kernel`) stages rows through a ring of S shared-memory
//   slots. Two loader warps, rows in turn, keep up to S rows in flight with
//   cp.async (16 B; a row's slot copy starts at the 16-B block of the row's
//   first byte, so source and slot agree modulo 16, and takes the
//   neighbouring bytes of that block and the last; narrower where the
//   tensor ends), and signal each slot's mbarrier when its copies land
//   (one warp's issue rate of copies bounded a row at 1280 columns). Walker
//   warps own the
//   columns (PER each, loads issued together); a row costs them the
//   mbarrier wait, a few shared-memory reads, and for 8-connectivity one
//   named barrier for the neighbour exchange of the carry row
//   (double-buffered in shared memory; the 4-connected carry stays in
//   registers), never a device-memory round trip.
// * The fixpoint is the walk with scanner warps: on the way down a scanner
//   applies the first K1 to each row as it lands in the ring, before the
//   walkers read it; on the way up it applies the last K1 to each row the
//   walkers emit into the ring, and writes it out. Scanners take rows in
//   turn, so several rows are scanned at once, ahead of the walkers. A
//   sweep thereby reads and writes the frame twice, not four times. After
//   the first sweep the first K1 is skipped: it follows the last K1 of the
//   sweep before, and K1 is idempotent (every run already holds its
//   minimum, background kInf), so it would change nothing. Each
//   pass notes whether it changed any pixel (a changed value, not only a
//   decrease: a background pixel holding anything but kInf counts); since
//   foreground labels only decrease and background only becomes kInf, a
//   sweep leaves the frame unchanged exactly when no pass changed it. The
//   block decides by __syncthreads_or whether to sweep again, so no host
//   synchronisation is involved and every warp leaves the loop together,
//   with no copy in flight (every row loaded was consumed). A frame that
//   stops early gives the labels of a batch-wide loop: it is a fixed point
//   of the sweep.
// * Every role advances its place in the ring (`Ring`: slot, mbarrier
//   parity, row count) once a row, through every pass, so all agree without
//   a division a row. A role that skips rows (a loader takes every other
//   row, a scanner every scanners-th) must never reach a slot two phases
//   early, where a parity wait would pass on the phase before: so the
//   stages are even (a slot keeps its loader) and there are no more
//   scanners than stages (rows wider than 4096 get fewer than 16 stages).
// * 4-connected columns are independent, so the standalone K4 splits a
//   frame into bands of kBand4 columns, one block each.

#include "ccl_rows.cuh"

namespace {

// K1 alone: a warp per row; the row is staged in shared memory (one read),
// scanned there by `k1_row`, and written back (one write).
__global__ void __launch_bounds__(kHpassRows * kWarp) hpass_kernel(const int32_t* __restrict__ lab,
                                                                   const uint8_t* __restrict__ fg,
                                                                   int32_t* __restrict__ out, long long rows,
                                                                   int W, int seg, size_t row_bytes) {
  extern __shared__ __align__(16) char smem_buf[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // whole warp leaves together; no block barrier follows
  int32_t* lab_s = reinterpret_cast<int32_t*>(smem_buf + warp * row_bytes);
  uint8_t* fg_s = reinterpret_cast<uint8_t*>(lab_s + W);
  const int32_t* lab_r = lab + row * W;
  const uint8_t* fg_r = fg + row * W;
  for (int x = lane; x < W; x += kWarp) {
    lab_s[x] = lab_r[x];
    fg_s[x] = fg_r[x];
  }
  __syncwarp();
  k1_row(lab_s, fg_s, W, seg, lane);
  __syncwarp();
  int32_t* out_r = out + row * W;
  for (int x = lane; x < W; x += kWarp) out_r[x] = lab_s[x];
}

// The walker warps: row after row, carry = fg ? min(lab, N(carry)) : kInf.
// Each walker thread owns PER columns, strided by the walker count; a row's
// loads of all of them issue together, then the stores. The 4-connected
// carry stays in registers; the 8-connected one goes through shared memory
// (double-buffered) for the neighbour exchange. Down the fixpoint the
// walkers read rows after the first K1 (`mid`) and write the result out; up
// they write it into the slot for the last K1. The standalone pass reads
// landed rows (`full`) and writes out. Returns whether a value changed.
template <int PER>
__device__ int walk(const WalkArgs& a, const Frame& f, char* slots, int32_t* carry, uint64_t* full,
                    uint64_t* mid, uint64_t* empty, Ring& ring, bool up, int wt, int lane) {
  const bool eight = a.conn == 2;
  const bool into_slot = a.fixpoint && up;
  int32_t* prev = carry;
  int32_t* next = carry + a.band;
  int cr[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    cr[k] = kInf;
    const int c = wt + k * a.walkers;
    if (eight && c < f.bw) prev[c] = kInf;
  }
  if (eight) walkers_sync(a.walkers);
  int changed = 0;
  for (int n = 0; n < a.H; ++n, ring.next(a.stages)) {
    const int r = up ? a.H - 1 - n : n;
    const int s = ring.slot;
    bar_wait(a.fixpoint && !up ? &mid[s] : &full[s], ring.phase);
    const size_t off = f.base + static_cast<size_t>(r) * a.W;
    char* slot = slots + s * a.slot_bytes;
    int32_t* lab_s = in_slot<int32_t>(slot, a.src + off);
    const uint8_t* fg_s = in_slot<const uint8_t>(slot + a.lab_bytes, a.fg + off);
    int32_t* out_r = a.dst + off;
    int l[PER], on[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = wt + k * a.walkers;
      if (c < f.bw) {
        l[k] = lab_s[c];
        on[k] = fg_s[c];
        if (eight) {
          int m = prev[c];
          if (c > 0) m = min(m, prev[c - 1]);
          if (c + 1 < f.bw) m = min(m, prev[c + 1]);
          cr[k] = m;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = wt + k * a.walkers;
      if (c < f.bw) {
        const int v = on[k] ? min(l[k], cr[k]) : kInf;
        changed |= v != l[k];
        cr[k] = v;
        if (eight) next[c] = v;
        if (into_slot) {
          lab_s[c] = v;
        } else {
          out_r[c] = v;
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(into_slot ? &mid[s] : &empty[s], 1);
    if (eight) {
      // Row r+1 reads what every walker wrote for row r: one barrier a row.
      walkers_sync(a.walkers);
      int32_t* tmp = prev;
      prev = next;
      next = tmp;
    }
  }
  return changed;
}

// A scanner warp of the fixpoint: K1 on its rows (the scanners take rows in
// turn) in the ring, before the walkers down, after them up (then out to
// memory). Down a sweep after the first it only hands the rows on: the
// first K1 of a sweep then follows the last K1 of the sweep before, and K1
// twice is K1.
__device__ int scan(const WalkArgs& a, const Frame& f, char* slots, uint64_t* full, uint64_t* mid,
                    uint64_t* empty, Ring& ring, bool up, bool first, int j, int lane) {
  const unsigned walker_warps = a.walkers / kWarp;
  int changed = 0;
  int turn = static_cast<int>(ring.row % a.scanners);
  for (int n = 0; n < a.H; ++n, ring.next(a.stages)) {
    const bool mine = turn == j;
    if (++turn == a.scanners) turn = 0;
    if (!mine) continue;
    const int r = up ? a.H - 1 - n : n;
    const int s = ring.slot;
    bar_wait(up ? &mid[s] : &full[s], ring.phase);
    const size_t off = f.base + static_cast<size_t>(r) * a.W;
    char* slot = slots + s * a.slot_bytes;
    int32_t* lab_s = in_slot<int32_t>(slot, a.src + off);
    const uint8_t* fg_s = in_slot<const uint8_t>(slot + a.lab_bytes, a.fg + off);
    if (up || first) changed |= k1_row(lab_s, fg_s, f.bw, a.seg, lane);
    __syncwarp();
    if (up) {
      int32_t* out_r = a.dst + off;
      for (int x = lane; x < f.bw; x += kWarp) out_r[x] = lab_s[x];
      __syncwarp();
    }
    if (lane == 0) bar_arrive(up ? &empty[s] : &mid[s], walker_warps);
  }
  return changed;
}

// One block walks columns [c0, c0 + band) of one frame: the first kLoaders
// warps load, the next walkers / 32 warps walk, the a.scanners after them
// (the fixpoint only) scan.
template <int PER>
__global__ void __launch_bounds__(1024, 1) walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) char smem_buf[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_buf);
  uint64_t* mid = full + kMaxStages;
  uint64_t* empty = mid + kMaxStages;
  int32_t* carry = reinterpret_cast<int32_t*>(smem_buf + a.carry_off);
  char* slots = smem_buf + a.slots_off;

  const int bands = (a.W + a.band - 1) / a.band;
  const int b = blockIdx.x / bands;
  const int c0 = (blockIdx.x % bands) * a.band;
  const Frame f{static_cast<size_t>(b) * a.H * a.W + c0, min(a.band, a.W - c0)};
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int walker_warps = a.walkers / kWarp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(&full[s], kWarp);
      bar_init(&mid[s], walker_warps);
      bar_init(&empty[s], walker_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Ring ring;
  auto pass = [&](bool up, bool first) -> int {
    if (warp < kLoaders) {
      produce(a, f, slots, full, empty, ring, up, warp, lane);
      return 0;
    }
    if (warp < kLoaders + walker_warps) {
      return walk<PER>(a, f, slots, carry, full, mid, empty, ring, up, threadIdx.x - kLoaders * kWarp, lane);
    }
    return scan(a, f, slots, full, mid, empty, ring, up, first, warp - kLoaders - walker_warps, lane);
  };

  if (!a.fixpoint) {
    pass(a.reverse != 0, true);
    return;
  }
  for (int sweep = 1;; ++sweep) {
    int changed = pass(false, sweep == 1);
    __syncthreads();  // the pass's writes reach the next pass's copies
    changed |= pass(true, sweep == 1);
    if (!__syncthreads_or(changed) || sweep >= a.max_iters) {
      if (threadIdx.x == 0) a.sweeps[b] = sweep;
      return;
    }
  }
}

template <int PER>
int launch_walk_per(const WalkArgs& a, unsigned blocks, cudaStream_t stream) {
  const size_t smem_bytes = a.slots_off + a.stages * a.slot_bytes;
  const int threads = kLoaders * kWarp + a.walkers + a.scanners * kWarp;
  cudaError_t e = cudaFuncSetAttribute(walk_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  walk_kernel<PER><<<blocks, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_walk(const WalkArgs& a, unsigned blocks, cudaStream_t stream) {
  switch (a.per) {
    case 1: return launch_walk_per<1>(a, blocks, stream);
    case 2: return launch_walk_per<2>(a, blocks, stream);
    case 4: return launch_walk_per<4>(a, blocks, stream);
    case 8: return launch_walk_per<8>(a, blocks, stream);
    case 16: return launch_walk_per<16>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// lab, out: contiguous int32 rows of W; fg: bool/uint8 rows of W (W <= 46000,
// the row must fit a block's shared memory; wider rows take hpass_wide_launch
// of ccl_banded.cu).
extern "C" int hpass_launch(const void* lab, const void* fg, void* out, long long rows, int W, void* stream) {
  if (rows <= 0 || W <= 0) return 0;
  const size_t row_bytes = round16(5 * static_cast<size_t>(W));
  if (row_bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = static_cast<int>(std::max<size_t>(1, std::min<size_t>(kHpassRows, 98304 / row_bytes)));
  const size_t smem_bytes = per_block * row_bytes;
  cudaError_t e = cudaFuncSetAttribute(hpass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  hpass_kernel<<<blocks, per_block * kWarp, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lab), static_cast<const uint8_t*>(fg), static_cast<int32_t*>(out), rows, W,
      k1_seg(W), row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// lab, out: (B, H, W) int32; fg: (B, H, W) bool/uint8; all contiguous.
// connectivity: 1 (4-connected, bands of kBand4 columns) or 2 (8-connected,
// W <= 8192; wider rows take vertical_pass_banded_launch of ccl_banded.cu).
extern "C" int vertical_pass_launch(const void* lab, const void* fg, void* out, int B, int H, int W,
                                    int connectivity, int reverse, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (connectivity != 1 && connectivity != 2) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.src = static_cast<const int32_t*>(lab);
  a.dst = static_cast<int32_t*>(out);
  a.fg = static_cast<const uint8_t*>(fg);
  a.total = static_cast<long long>(B) * H * W;
  a.H = H;
  a.W = W;
  a.conn = connectivity;
  a.reverse = reverse;
  if (!plan(a, connectivity == 1 ? std::min(kBand4, W) : W, connectivity))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned bands = static_cast<unsigned>((W + a.band - 1) / a.band);
  return launch_walk(a, static_cast<unsigned>(B) * bands, static_cast<cudaStream_t>(stream));
}

// lab: (B, H, W) int32, updated in place; fg: (B, H, W) bool/uint8; sweeps:
// (B,) int32, the sweeps each frame ran (at least 1, at most
// max(1, max_iters)); all contiguous. One block per frame, W <= 8192 (wider
// rows take ccl_fixpoint_banded_launch of ccl_banded.cu).
extern "C" int ccl_fixpoint_launch(void* lab, const void* fg, void* sweeps, int B, int H, int W,
                                   int connectivity, int max_iters, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (connectivity != 1 && connectivity != 2) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.src = static_cast<const int32_t*>(lab);
  a.dst = static_cast<int32_t*>(lab);
  a.fg = static_cast<const uint8_t*>(fg);
  a.total = static_cast<long long>(B) * H * W;
  a.H = H;
  a.W = W;
  a.conn = connectivity;
  a.fixpoint = 1;
  a.max_iters = max_iters;
  a.seg = k1_seg(W);
  a.sweeps = static_cast<int32_t*>(sweeps);
  if (!plan(a, W, connectivity)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_walk(a, static_cast<unsigned>(B), static_cast<cudaStream_t>(stream));
}
