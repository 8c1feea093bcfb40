// The banded route of the connected-component labelling (ops/label.py,
// ops/row_scan.py): the label fixpoint and the 8-connected vertical pass on
// rows wider than one block of ccl.cu walks (8192 columns), and the
// horizontal pass on rows wider than a block stages (46000). ccl.cu holds
// the one-block route and its design; both share ccl_rows.cuh.
//
// Three entry points, each bound to Python through a plain C launcher
// (ctypes); each launches on the caller's stream, allocates nothing and
// returns the error code of the launch (0 = launched):
//
//   ccl_fixpoint_banded_launch   the fixpoint of ccl_fixpoint_launch, a block
//                                a band;
//   vertical_pass_banded_launch  K4 alone, 8-connected, a block a band;
//   hpass_wide_launch            K1 alone: a block a row, in chunks.
//
// They replace, on wide rows, what ccl.cu replaces: the `jax.lax.while_loop`
// of `label` in maze_image_processing_pipeline_tpu/ops/label.py, K4
// (`vertical_pass_pallas`, attic/pallas_label.py) and K1 (`hpass_pallas`,
// maze_image_processing_pipeline_tpu/ops/pallas_scan.py). The bound is
// ccl.cu's; the exchange adds a round trip through L2 a row.
//
// The banded route. A frame is cut into bands of 512 columns, or wider ones
// up to 8192 where a frame would need more bands than the card has SMs
// (ops/label.py:ccl_route: a band's rows cost more a column the wider it
// is), a block each, and the bands of a frame exchange
// what crosses their edges through a workspace in device memory:
// * K4, 8-connected: row r+1 of a band's edge column needs the carry of the
//   neighbour's edge column at row r. Each band publishes its two edge
//   carries a row; the walker thread of an edge column waits for the
//   neighbour's before it finishes that column. 4-connected columns
//   exchange nothing.
// * K1: after its own scan of a row, a band publishes the row's summary:
//   the minimum of the run at its left edge, of the run at its right edge,
//   and whether it is foreground throughout. A run that crosses edges takes
//   the minimum over the chain of bands it spans, found by looking back
//   over the neighbours' summaries, leftwards and rightwards, as far as
//   their bands are foreground throughout.
// * Stopping: a sweep's "changed" is an OR over the frame's bands, through
//   one flag a band, so the bands of a frame stop together and count the
//   sweeps as the one-block route counts them.
// Every slot of the workspace holds a tag beside its values: the call's
// epoch (the wrapper numbers its calls) and the sweep. A reader waits with
// an acquire load until the slot holds its tag; the writer stores the
// values, then the tag with a release store. So nothing is zeroed between
// calls. Slots are per frame, band, pass direction and row, and the flags
// alternate between two a band by the sweep's parity: a slot is written
// again only in a later sweep, which no band begins before every band has
// published its flag of the sweep before, after all its reads. A band waits
// on its neighbours, so all the bands of a frame must be resident at once:
// the launch is cooperative (it is refused, never hung, where the card
// cannot hold them), and where it cannot hold every frame's bands, its
// blocks take the frames in groups, one after another, in the same launch.
//
// The wide K1 (hpass_wide_kernel): a block a row, a warp a chunk of 4096
// columns at a time (staged, scanned by k1_row, written out, its edge runs
// noted); two threads then chain the chunks' edge runs leftwards and
// rightwards, and the warps lower each chunk's edge runs in the output.

#include "ccl_rows.cuh"

namespace {

constexpr int kWideChunk = 4096;                     // columns a warp of K1's wide route scans at once
constexpr int kWideWarps = 8;                        // warps (chunks at once) a block of K1's wide route
constexpr size_t kWideChunkBytes = 5 * kWideChunk;  // a warp's staged labels and mask bytes

// Lowers lab[from, to) to at most m, a warp's lanes strided over the span
// (shared or device memory). Returns whether this lane changed a value.
__device__ __forceinline__ int lower_band(int32_t* lab, int from, int to, int m, int lane) {
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

// Where a row's background lies, for the runs that leave it at its edges:
// the first and last background column (W and -1 where there is none), and
// whether the row is foreground throughout. One warp, over W mask bytes;
// every lane gets the same.
struct RowEdges {
  int first_bg, last_bg, pass;
};

__device__ __forceinline__ RowEdges row_edges(const uint8_t* fg, int W, int lane) {
  int first = W, last = -1;
  for (int x = lane; x < W; x += kWarp) {
    if (!fg[x]) {
      first = min(first, x);
      last = x;
    }
  }
  RowEdges e;
  e.first_bg = __reduce_min_sync(kFull, first);
  e.last_bg = __reduce_max_sync(kFull, last);
  e.pass = e.first_bg == W;
  return e;
}


// K1 alone on rows wider than a block's shared memory holds (the wide
// route): a block per row takes it in chunks of kWideChunk columns, a warp
// a chunk: staged, scanned by `k1_row`, written out, its edge runs noted in
// the workspace (`ChunkSum`). Then two threads chain the chunks' edge runs,
// leftwards and rightwards, as the banded fixpoint's look-back does, and
// the warps lower each chunk's edge runs in the output to what crosses in.
struct ChunkSum {
  int head, tail;           // minimum of the run at the chunk's left and right edge (kInf: none)
  int first_bg, last_bg;    // RowEdges of the chunk
  int pass;
  int left, right;          // minimum of the runs that cross in from the left and the right
  int pad;
};

__global__ void __launch_bounds__(kWideWarps * kWarp) hpass_wide_kernel(const int32_t* __restrict__ lab,
                                                                        const uint8_t* __restrict__ fg,
                                                                        int32_t* __restrict__ out,
                                                                        ChunkSum* __restrict__ ws, long long rows,
                                                                        int W) {
  extern __shared__ __align__(16) char smem_buf[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int chunks = (W + kWideChunk - 1) / kWideChunk;
  const int seg = k1_seg(kWideChunk);
  int32_t* lab_s = reinterpret_cast<int32_t*>(smem_buf + warp * kWideChunkBytes);
  uint8_t* fg_s = reinterpret_cast<uint8_t*>(lab_s + kWideChunk);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int32_t* lab_r = lab + row * W;
    const uint8_t* fg_r = fg + row * W;
    int32_t* out_r = out + row * W;
    ChunkSum* sums = ws + row * chunks;
    for (int q = warp; q < chunks; q += kWideWarps) {
      const int c0 = q * kWideChunk, cw = min(kWideChunk, W - c0);
      for (int x = lane; x < cw; x += kWarp) {
        lab_s[x] = lab_r[c0 + x];
        fg_s[x] = fg_r[c0 + x];
      }
      __syncwarp();
      const RowEdges e = row_edges(fg_s, cw, lane);
      k1_row(lab_s, fg_s, cw, seg, lane);
      __syncwarp();
      for (int x = lane; x < cw; x += kWarp) out_r[c0 + x] = lab_s[x];
      if (lane == 0) {
        ChunkSum& c = sums[q];
        c.head = fg_s[0] ? lab_s[0] : kInf;
        c.tail = fg_s[cw - 1] ? lab_s[cw - 1] : kInf;
        c.first_bg = e.first_bg;
        c.last_bg = e.last_bg;
        c.pass = e.pass;
      }
      __syncwarp();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int in = kInf;
      for (int q = 0; q < chunks; ++q) {
        sums[q].left = in;
        in = sums[q].pass ? min(in, sums[q].tail) : sums[q].tail;
      }
    } else if (threadIdx.x == kWarp) {
      int in = kInf;
      for (int q = chunks - 1; q >= 0; --q) {
        sums[q].right = in;
        in = sums[q].pass ? min(in, sums[q].head) : sums[q].head;
      }
    }
    __syncthreads();
    for (int q = warp; q < chunks; q += kWideWarps) {
      const ChunkSum c = sums[q];
      int32_t* o = out_r + q * kWideChunk;
      const int cw = min(kWideChunk, W - q * kWideChunk);
      if (c.pass) {
        lower_band(o, 0, cw, min(c.left, c.right), lane);
      } else {
        lower_band(o, 0, c.first_bg, c.left, lane);
        lower_band(o, c.last_bg + 1, cw, c.right, lane);
      }
    }
    __syncthreads();  // the chunk sums and the staged rows, before the next row
  }
}


// ---- The banded route: a frame's bands exchange through device memory -----------
//
// walk_banded, scan_banded and walk_banded_kernel are ccl.cu's walk, scan and
// walk_kernel with the exchange added (marked "banded"); ccl.cu's are kept
// apart so that the one-block route's code does not change.

// A slot of the workspace: two values behind a tag (epoch, sweep).
struct Slot {
  unsigned long long tag;
  int x, y;
};

// A (frame, band)'s slots: K1's row summaries [2 passes][H], the sweep's
// "changed" flags [2, by the sweep's parity], then, 8-connected, K4's edge
// carries [2 passes][2 sides][H rows].
__host__ __device__ inline long long unit_slots(int H, int conn) {
  return 2LL * H + 2 + (conn == 2 ? 4LL * H : 0);
}

constexpr int kLeftEdge = 0, kRightEdge = 1;
constexpr unsigned long long kWaitLimitNs = 10000000000ull;  // 10 s
constexpr unsigned kWaitLimitPolls = 1u << 30;               // minutes of polls

// The banded route's arguments beside the walk's.
struct BandArgs {
  int B;
  int bands;           // bands a frame: ceil(W / band)
  Slot* ws;            // the exchange workspace: unit_slots a (frame, band)
  long long unit_slots;
  unsigned epoch;      // this call's number, in every tag it writes
};

// The frame and band a block works on.
struct Band {
  int b, j;
};

__device__ __forceinline__ Slot* unit(const BandArgs& x, Band g, int j) {
  return x.ws + (static_cast<long long>(g.b) * x.bands + j) * x.unit_slots;
}
__device__ __forceinline__ Slot* sum_slot(const WalkArgs& a, const BandArgs& x, Band g, int j, int dir, int r) {
  return unit(x, g, j) + dir * a.H + r;
}
__device__ __forceinline__ Slot* flag_slot(const WalkArgs& a, const BandArgs& x, Band g, int j, int sweep) {
  return unit(x, g, j) + 2 * a.H + (sweep & 1);
}
__device__ __forceinline__ Slot* carry_slot(const WalkArgs& a, const BandArgs& x, Band g, int j, int dir, int side,
                                            int n) {
  return unit(x, g, j) + 2 * a.H + 2 + (2 * dir + side) * a.H + n;
}

__device__ __forceinline__ unsigned long long make_tag(unsigned epoch, int sweep) {
  return (static_cast<unsigned long long>(epoch) << 32) | static_cast<unsigned>(sweep);
}

// The values, then the tag with a release store.
__device__ __forceinline__ void publish(Slot* s, unsigned long long tag, int x, int y) {
  asm volatile("st.volatile.global.v2.s32 [%0], {%1, %2};" ::"l"(&s->x), "r"(x), "r"(y) : "memory");
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(&s->tag), "l"(tag) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits (acquire loads, back to back: a nap between polls cost the banded
// fixpoint several times its time) until the slot holds `tag`, then reads
// its values. A wait that outlasts kWaitLimitNs (a fault, never a slow
// neighbour; the clock is read once every 1024 polls), or kWaitLimitPolls
// where the clock stands still, traps instead of holding the card. A trap is
// a sticky error: it ends the process's CUDA context, so this launch and
// every later CUDA call of the process fail, and only a new process uses
// the card again. (Raising from a device flag instead would cost the
// wrapper a host synchronisation a call.)
__device__ __forceinline__ int2 await(const Slot* s, unsigned long long tag) {
  unsigned long long since = 0;
  for (unsigned polls = 1;; ++polls) {
    unsigned long long t;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(t) : "l"(&s->tag) : "memory");
    if (t == tag) break;
    if ((polls & 1023) == 0) {
      const unsigned long long now = global_ns();
      if (since == 0) since = now;
      if (now - since > kWaitLimitNs || polls >= kWaitLimitPolls) __trap();
    }
  }
  int2 v;
  asm volatile("ld.volatile.global.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(&s->x) : "memory");
  return v;
}

// K1 of row r across the frame's bands: this band's scan, then the runs that
// cross its edges. The band publishes its summary (x: the run at its left
// edge, bit 31 set where the band is foreground throughout; y: the run at
// its right edge; kInf where the edge pixel is background), then looks back
// over its neighbours' summaries as far as they are foreground throughout:
// lane 0 leftwards (their right-edge runs), lane 1 rightwards.
__device__ int k1_band(const WalkArgs& a, const BandArgs& x, const Frame& f, Band g, int32_t* lab, const uint8_t* fg, int dir, int r,
                       int sweep, int lane) {
  const RowEdges e = row_edges(fg, f.bw, lane);
  int changed = k1_row(lab, fg, f.bw, a.seg, lane);
  __syncwarp();
  const unsigned long long tag = make_tag(x.epoch, sweep);
  const bool open_l = fg[0] != 0, open_r = fg[f.bw - 1] != 0;
  if (lane == 0) {
    publish(sum_slot(a, x, g, g.j, dir, r), tag, (open_l ? lab[0] : kInf) | (e.pass ? INT32_MIN : 0),
            open_r ? lab[f.bw - 1] : kInf);
  }
  int in = kInf;
  if (lane == 0 && open_l) {
    for (int j = g.j - 1; j >= 0; --j) {
      const int2 v = await(sum_slot(a, x, g, j, dir, r), tag);
      in = min(in, v.y);
      if (v.x >= 0) break;  // background in band j: the run starts there
    }
  }
  if (lane == 1 && open_r) {
    for (int j = g.j + 1; j < x.bands; ++j) {
      const int2 v = await(sum_slot(a, x, g, j, dir, r), tag);
      in = min(in, v.x & INT32_MAX);
      if (v.x >= 0) break;
    }
  }
  const int left = __shfl_sync(kFull, in, 0), right = __shfl_sync(kFull, in, 1);
  if (e.pass) {
    changed |= lower_band(lab, 0, f.bw, min(left, right), lane);
  } else {
    changed |= lower_band(lab, 0, e.first_bg, left, lane);
    changed |= lower_band(lab, e.last_bg + 1, f.bw, right, lane);
  }
  return changed;
}

// The OR of a sweep's "changed" over the frame's bands: thread 0 publishes
// this band's flag, waits for the others', and hands the OR to the block.
__device__ int frame_or(const WalkArgs& a, const BandArgs& x, Band g, int changed, int sweep, int* any) {
  if (threadIdx.x == 0) {
    const unsigned long long tag = make_tag(x.epoch, sweep);
    publish(flag_slot(a, x, g, g.j, sweep), tag, changed, 0);
    for (int j = 0; j < x.bands; ++j) {
      if (j != g.j) changed |= await(flag_slot(a, x, g, j, sweep), tag).x;
    }
    *any = changed;
  }
  __syncthreads();
  return *any;
}

// `walk` of the banded route: 8-connected, the walker thread of an edge
// column waits for the neighbour band's carry of the row before (kRightEdge
// of the band to the left, kLeftEdge of the band to the right) and
// publishes its own carry of each row.
template <int PER>
__device__ int walk_banded(const WalkArgs& a, const BandArgs& x, const Frame& f, Band g, char* slots, int32_t* carry, uint64_t* full,
                           uint64_t* mid, uint64_t* empty, Ring& ring, bool up, int sweep, int wt, int lane) {
  const bool eight = a.conn == 2;
  const bool into_slot = a.fixpoint && up;
  const bool left_band = eight && g.j > 0, right_band = eight && g.j + 1 < x.bands;  // banded
  const int dir = up ? 1 : 0;
  const unsigned long long tag = make_tag(x.epoch, sweep);
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
          // banded: the neighbours' edge carries of the row before
          if (n > 0 && c == 0 && left_band) m = min(m, await(carry_slot(a, x, g, g.j - 1, dir, kRightEdge, n - 1), tag).x);
          if (n > 0 && c == f.bw - 1 && right_band) {
            m = min(m, await(carry_slot(a, x, g, g.j + 1, dir, kLeftEdge, n - 1), tag).x);
          }
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
        // banded: this band's edge carries of the row
        if (c == 0 && left_band) publish(carry_slot(a, x, g, g.j, dir, kLeftEdge, n), tag, v, 0);
        if (c == f.bw - 1 && right_band) publish(carry_slot(a, x, g, g.j, dir, kRightEdge, n), tag, v, 0);
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
      walkers_sync(a.walkers);
      int32_t* tmp = prev;
      prev = next;
      next = tmp;
    }
  }
  return changed;
}

// `scan` of the banded route: K1 across the frame's bands (`k1_band`).
__device__ int scan_banded(const WalkArgs& a, const BandArgs& x, const Frame& f, Band g, char* slots, uint64_t* full, uint64_t* mid,
                           uint64_t* empty, Ring& ring, bool up, bool first, int sweep, int j, int lane) {
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
    if (up || first) changed |= k1_band(a, x, f, g, lab_s, fg_s, up ? 1 : 0, r, sweep, lane);
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

// `walk_kernel` of the banded route: block i takes band i % bands of the
// frames i / bands, + groups, ... (groups = gridDim.x / bands); the bands of
// a frame stop together (`frame_or`).
template <int PER>
__global__ void __launch_bounds__(1024, 1) walk_banded_kernel(WalkArgs a, BandArgs x) {
  extern __shared__ __align__(16) char smem_buf[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_buf);
  uint64_t* mid = full + kMaxStages;
  uint64_t* empty = mid + kMaxStages;
  int* any = reinterpret_cast<int*>(empty + kMaxStages);  // frame_or's result
  int32_t* carry = reinterpret_cast<int32_t*>(smem_buf + a.carry_off);
  char* slots = smem_buf + a.slots_off;

  const int j = blockIdx.x % x.bands, groups = gridDim.x / x.bands;
  const int c0 = j * a.band;
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
  for (int b = blockIdx.x / x.bands; b < x.B; b += groups) {
    const Frame f{static_cast<size_t>(b) * a.H * a.W + c0, min(a.band, a.W - c0)};
    const Band g{b, j};
    auto pass = [&](bool up, bool first, int sweep) -> int {
      if (warp < kLoaders) {
        produce(a, f, slots, full, empty, ring, up, warp, lane);
        return 0;
      }
      if (warp < kLoaders + walker_warps) {
        return walk_banded<PER>(a, x, f, g, slots, carry, full, mid, empty, ring, up, sweep,
                                threadIdx.x - kLoaders * kWarp, lane);
      }
      return scan_banded(a, x, f, g, slots, full, mid, empty, ring, up, first, sweep, warp - kLoaders - walker_warps,
                         lane);
    };

    if (!a.fixpoint) {
      pass(a.reverse != 0, true, 1);
      continue;
    }
    for (int sweep = 1;; ++sweep) {
      int changed = pass(false, sweep == 1, sweep);
      __syncthreads();  // the pass's writes reach the next pass's copies
      changed |= pass(true, sweep == 1, sweep);
      if (!frame_or(a, x, g, __syncthreads_or(changed), sweep, any) || sweep >= a.max_iters) {
        if (threadIdx.x == 0 && j == 0) a.sweeps[b] = sweep;
        break;
      }
    }
  }
}

template <int PER>
int launch_banded_per(const WalkArgs& a, const BandArgs& x, cudaStream_t stream) {
  const size_t smem_bytes = a.slots_off + a.stages * a.slot_bytes;
  const int threads = kLoaders * kWarp + a.walkers + a.scanners * kWarp;
  cudaError_t e = cudaFuncSetAttribute(walk_banded_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes));
  // The bands of a frame wait on each other: every block must be resident.
  // Frames go in groups of what the card holds; the blocks loop over them.
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_banded_kernel<PER>, threads, smem_bytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = std::min<long long>(x.B, static_cast<long long>(per_sm) * sms / x.bands);
  if (groups < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  WalkArgs args = a;
  BandArgs band_args = x;
  void* params[] = {&args, &band_args};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(walk_banded_kernel<PER>),
                                                      dim3(static_cast<unsigned>(groups * x.bands)), dim3(threads),
                                                      params, smem_bytes, stream));
}

int launch_banded(const WalkArgs& a, const BandArgs& x, cudaStream_t stream) {
  switch (a.per) {
    case 1: return launch_banded_per<1>(a, x, stream);
    case 2: return launch_banded_per<2>(a, x, stream);
    case 4: return launch_banded_per<4>(a, x, stream);
    case 8: return launch_banded_per<8>(a, x, stream);
    case 16: return launch_banded_per<16>(a, x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The banded route's common arguments: `band` columns a block,
// ceil(W / band) bands a frame, the workspace and the call's epoch.
BandArgs banded_args(const WalkArgs& a, int B, int band, void* ws, unsigned epoch) {
  return BandArgs{B, (a.W + band - 1) / band, static_cast<Slot*>(ws), unit_slots(a.H, a.conn), epoch};
}

}  // namespace

// The fixpoint of ccl_fixpoint_launch on the banded route: bands of `band`
// columns, a block each. ws: the exchange workspace, B * ceil(W / band) *
// unit_slots(H, connectivity) 16-byte slots, zeroed when made and only ever
// written by these launches; epoch: this call's number, 1, 2, ... (a
// workspace is zeroed again before its numbers wrap). Returns
// cudaErrorCooperativeLaunchTooLarge where the card cannot hold a frame's
// bands at once.
extern "C" int ccl_fixpoint_banded_launch(void* lab, const void* fg, void* sweeps, void* ws, int B, int H, int W,
                                          int band, int connectivity, int max_iters, unsigned epoch, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if ((connectivity != 1 && connectivity != 2) || band < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  a.seg = k1_seg(band);
  a.sweeps = static_cast<int32_t*>(sweeps);
  if (!plan(a, band, connectivity, true)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_banded(a, banded_args(a, B, band, ws, epoch), static_cast<cudaStream_t>(stream));
}

// K4 alone, 8-connected, on the banded route (as ccl_fixpoint_banded_launch;
// ws holds B * ceil(W / band) * unit_slots(H, 2) slots).
extern "C" int vertical_pass_banded_launch(const void* lab, const void* fg, void* out, void* ws, int B, int H, int W,
                                           int band, int reverse, unsigned epoch, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (band < 1) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.src = static_cast<const int32_t*>(lab);
  a.dst = static_cast<int32_t*>(out);
  a.fg = static_cast<const uint8_t*>(fg);
  a.total = static_cast<long long>(B) * H * W;
  a.H = H;
  a.W = W;
  a.conn = 2;
  a.reverse = reverse;
  if (!plan(a, band, 2, true)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_banded(a, banded_args(a, B, band, ws, epoch), static_cast<cudaStream_t>(stream));
}

// K1 alone on rows wider than hpass_launch takes: lab, out, fg as there;
// ws: rows * ceil(W / kWideChunk) ChunkSums of scratch.
extern "C" int hpass_wide_launch(const void* lab, const void* fg, void* out, void* ws, long long rows, int W,
                                 void* stream) {
  if (rows <= 0 || W <= 0) return 0;
  const size_t smem_bytes = kWideWarps * kWideChunkBytes;
  cudaError_t e = cudaFuncSetAttribute(hpass_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(std::min<long long>(rows, 1 << 16));
  hpass_wide_kernel<<<blocks, kWideWarps * kWarp, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lab), static_cast<const uint8_t*>(fg), static_cast<int32_t*>(out),
      static_cast<ChunkSum*>(ws), rows, W);
  return static_cast<int>(cudaGetLastError());
}
