// The connected-component labelling's row machinery, shared by ccl.cu (one
// block a frame) and ccl_banded.cu (the banded route for rows wider than one
// block walks): K1's row function `k1_row`, the walk's arguments, the ring
// of staged rows (`Ring`, `produce`) and its plan (`plan`). ccl.cu describes
// the design.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kInf = 1 << 30;  // background label of the CCL
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemMax = 232448;  // the 227 KB a block may use
constexpr int kMaxStages = 16;
constexpr int kMaxScanWarps = 16;    // scanner warps of the fixpoint, at most
constexpr int kLoaders = 2;          // loader warps, rows in turn
constexpr int kMaxWalkThreads = 512;
constexpr int kBand4 = 256;          // columns a block of the 4-connected pass
constexpr int kHpassRows = 8;        // rows (warps) a block of K1 alone
constexpr int kChunk = 8;            // elements a lane of k1_row loads at once

// ---- K1: the row function -----------------------------------------------------

// Lowers lab[from, to) to at most m; chunked so the loads of a chunk issue
// together. Returns whether a value changed.
__device__ __forceinline__ bool lower_to(int32_t* lab, int from, int to, int m) {
  bool changed = false;
  for (int base = from; base < to; base += kChunk) {
    int v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) v[q] = base + q < to ? lab[base + q] : 0;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (base + q < to && m < v[q]) {
        lab[base + q] = m;
        changed = true;
      }
    }
  }
  return changed;
}

// The segmented min-scan of one row of W labels and mask bytes held in
// shared memory, by one warp, in place: the run minimum on foreground,
// kInf on background. `seg` is odd and at least ceil(W / 32). Each lane
// walks its segment in chunks of kChunk: a chunk's loads issue together,
// the scan runs in registers, the stores follow. Returns whether this lane
// changed any value.
__device__ bool k1_row(int32_t* lab, const uint8_t* fg, int W, int seg, int lane) {
  const int lo = min(W, lane * seg);
  const int hi = min(W, lo + seg);
  bool changed = false;

  // Forward within the segment: the minimum since the run's start.
  int run = kInf;
  int first_bg = hi;
  for (int base = lo; base < hi; base += kChunk) {
    int v[kChunk], f[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const bool in = base + q < hi;
      v[q] = in ? lab[base + q] : kInf;
      f[q] = in ? fg[base + q] : 0;
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (base + q < hi) {
        if (f[q]) {
          run = min(run, v[q]);
        } else {
          run = kInf;
          first_bg = min(first_bg, base + q);
        }
        changed |= run != v[q];
        v[q] = run;
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (base + q < hi) lab[base + q] = v[q];
    }
  }
  const int tail = run;  // the run open at the segment's right edge
  const bool pass = first_bg == hi;  // no background: runs pass through

  // Back within the segment: the minimum over the whole run in the segment.
  run = kInf;
  int last_bg = lo - 1;
  for (int top = hi; top > lo; top -= kChunk) {
    int v[kChunk], f[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int k = top - 1 - q;
      const bool in = k >= lo;
      v[q] = in ? lab[k] : kInf;
      f[q] = in ? fg[k] : 0;
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int k = top - 1 - q;
      if (k >= lo) {
        if (f[q]) {
          run = min(run, v[q]);
          changed |= run != v[q];
          v[q] = run;
        } else {
          run = kInf;
          last_bg = max(last_bg, k);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int k = top - 1 - q;
      if (k >= lo) lab[k] = v[q];
    }
  }
  const int head = run;  // the run open at the segment's left edge

  // Runs that cross segments: segmented scans over the lanes, rightwards of
  // the tails, leftwards of the heads; (kInf, pass) is the identity of an
  // empty segment.
  int lv = tail, rv = head;
  int lp = pass, rp = pass;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int olv = __shfl_up_sync(kFull, lv, d);
    const int olp = __shfl_up_sync(kFull, lp, d);
    const int orv = __shfl_down_sync(kFull, rv, d);
    const int orp = __shfl_down_sync(kFull, rp, d);
    if (lane >= d) {
      if (lp) lv = min(lv, olv);
      lp &= olp;
    }
    if (lane + d < kWarp) {
      if (rp) rv = min(rv, orv);
      rp &= orp;
    }
  }
  int left = __shfl_up_sync(kFull, lv, 1);
  int right = __shfl_down_sync(kFull, rv, 1);
  if (lane == 0) left = kInf;
  if (lane == kWarp - 1) right = kInf;

  // The segment's first run meets the left neighbours' run, its last run the
  // right neighbours'; a segment without background is one run.
  if (pass) {
    const int m = min(left, right);
    if (m < kInf) changed |= lower_to(lab, lo, hi, m);
  } else {
    if (left < kInf) changed |= lower_to(lab, lo, first_bg, left);
    if (right < kInf) changed |= lower_to(lab, last_bg + 1, hi, right);
  }
  return changed;
}

__host__ __device__ inline int k1_seg(int W) { return ((W + kWarp - 1) / kWarp) | 1; }

// ---- K4 and the fixpoint: the column walk through the ring ----------------------

struct WalkArgs {
  const int32_t* src;  // labels the walk reads (the fixpoint: == dst)
  int32_t* dst;        // labels it writes
  const uint8_t* fg;
  long long total;     // elements of each (B, H, W) tensor
  int H, W;
  int band;            // columns a block walks (W but for the 4-connected pass)
  int conn;            // 1: 4-connected, 2: 8-connected
  int reverse;         // the standalone pass: bottom to top
  int fixpoint;        // 1: sweeps of K1, K4 down, K4 up, K1 (scanner warps)
  int max_iters;
  int seg;             // k1_row's segment
  int per;             // columns a walker thread owns
  int scanners;        // scanner warps (the fixpoint)
  int stages;          // S, the ring's slots
  int walkers;         // walker threads, a multiple of 32
  size_t lab_bytes;    // a slot: labels, then mask bytes
  size_t slot_bytes;
  size_t carry_off;    // shared-memory offsets: barriers at 0, then carry, then slots
  size_t slots_off;
  int32_t* sweeps;     // (B,) sweeps run (the fixpoint)
};

struct Frame {
  size_t base;  // element offset of row 0, column c0
  int bw;       // columns walked
};

// A role's place in the ring: the slot of the current row, its mbarrier
// parity, and the row's count (which loader and scanner take it). Every role
// advances it once a row, through every pass, so all roles agree.
struct Ring {
  int slot = 0;
  unsigned phase = 0;
  unsigned row = 0;
  __device__ __forceinline__ void next(int stages) {
    ++row;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void walkers_sync(int walkers) {
  asm volatile("bar.sync 1, %0;" ::"r"(walkers) : "memory");
}

// A loader warp (one of kLoaders, rows in turn): copies its rows of one
// pass into the ring in walk order, each slot once its last readers have
// released it.
__device__ void produce(const WalkArgs& a, const Frame& f, char* slots, uint64_t* full, uint64_t* empty,
                        Ring& ring, bool up, int j, int lane) {
  const char* lab_lo = reinterpret_cast<const char*>(a.src);
  const char* fg_lo = reinterpret_cast<const char*>(a.fg);
  for (int n = 0; n < a.H; ++n, ring.next(a.stages)) {
    if (ring.row % kLoaders != static_cast<unsigned>(j)) continue;
    const int r = up ? a.H - 1 - n : n;
    const int s = ring.slot;
    bar_wait(&empty[s], ring.phase ^ 1);  // a fresh slot passes at once
    const size_t off = f.base + static_cast<size_t>(r) * a.W;
    char* slot = slots + s * a.slot_bytes;
    copy_span(slot, reinterpret_cast<const char*>(a.src + off), 4 * static_cast<size_t>(f.bw), lab_lo,
              lab_lo + 4 * a.total, lane);
    copy_span(slot + a.lab_bytes, reinterpret_cast<const char*>(a.fg + off), f.bw, fg_lo, fg_lo + a.total,
              lane);
    bar_arrive_on_copies(&full[s]);
    bar_arrive(&full[s], 1);  // after this lane's plain bytes, if any
  }
}

size_t round32(size_t n) { return (n + 31) / 32 * 32; }

// The ring, carry and threads for a walk of `band` columns: walker threads
// own PER columns each (the least power of two that needs at most
// kMaxWalkThreads of them), the fixpoint's scanners fill the block up to
// kMaxScanWarps and the ring's stages (an even number); the banded route
// keeps a word for `frame_or` beside the barriers. False if two slots do not
// fit, or PER would pass 16.
bool plan(WalkArgs& a, int band, int conn, bool banded = false) {
  a.band = band;
  a.per = 1;
  while ((band + a.per - 1) / a.per > kMaxWalkThreads) a.per *= 2;
  if (a.per > 16) return false;
  a.walkers = static_cast<int>(round32((band + a.per - 1) / a.per));
  a.scanners = a.fixpoint ? std::min(kMaxScanWarps, (1024 - kLoaders * kWarp - a.walkers) / kWarp) : 0;
  a.lab_bytes = round16(4 * static_cast<size_t>(band) + 32);
  a.slot_bytes = a.lab_bytes + round16(static_cast<size_t>(band) + 32);
  a.carry_off = round16(3 * kMaxStages * sizeof(uint64_t) + (banded ? sizeof(int) : 0));
  a.slots_off = a.carry_off + (conn == 2 ? round16(2 * 4 * static_cast<size_t>(band)) : 0);
  if (a.slots_off + 2 * a.slot_bytes > kSmemMax) return false;
  a.stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemMax - a.slots_off) / a.slot_bytes));
  // A role that skips rows must find each slot's mbarrier at most one phase
  // behind the phase it waits for, or its parity wait passes on the phase
  // before. A loader takes every other row: with an even number of stages
  // a slot always has the same loader, which loaded its last row itself. A
  // scanner takes every scanners-th row: no more scanners than stages.
  a.stages &= ~1;
  a.scanners = std::min(a.scanners, a.stages);
  return true;
}

}  // namespace
