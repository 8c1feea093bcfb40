// K7 and K3: the region measurement (ops/regionprops_fused.py) and the
// per-region intensity histogram (ops/region_histogram.py), for Hopper, in
// one kernel and one read of the labels and the intensity.
//
// Replaces the Pallas TPU kernels `regionprops_fused_pallas` of
// attic/pallas_props.py (its `_pass1_kernel`, which also writes the
// histogram) and `region_histogram_pallas` of attic/pallas_hist.py. For each
// frame b and region r in [0, R) (labels outside [0, R) are not measured)
// it computes, from the (B, H, W) int32 labels and uint8 intensity:
//
//   sums[b, r, :]        n1, n065, sum I, sum I*y, sum I*x      (int64)
//   rows[0..3, b, y, r]  count, x-sum, x-min (W if none), x-max (-1 if
//                        none) of the pixels of r in row y      (int32)
//   colcnt[b, x, r]      pixels of r in column x                (int32)
//   hist[b, r, c]        pixels of r with intensity c           (int32)
//
// Template flags pick the outputs: the partials with the histogram (the
// measurement with intensity), the partials alone (without intensity), or
// the histogram alone (K3's entry point). n1 and n065 count the perimeter:
// every 2x2 block of the zero-padded foreground mask (label > 0) has the
// marching-squares length 0, 0.65, 1.0 or 1.3 and is given to its
// raster-last foreground corner pixel; a pixel of r adds the blocks of
// length 1.0 to n1 and the 0.65-units to n065 (a block of 1.3 is two).
//
// Bound: device-memory bandwidth. The function reads the labels (4 B/px)
// and the intensity (1 B/px) once and writes the partials and the
// histogram: 64.0 MB at (8, 1024, 1280) with R = 64, 19.1 us at 3.35 TB/s.
//
// Two routes, chosen by the caller's plan before the launch
// (ops/region_histogram.py:region_measure_plan, a replica of `layout` and
// `choose_strip`): the shared-memory route (measure_kernel), wherever R <
// 2^15, W <= 2^16 and a strip of rows fits a block; else the
// device-memory route (measure_global_kernel, below), which takes any R and
// W. Every path shape of the port takes the shared-memory route.
//
// Design of the shared-memory route.
// * A frame is cut into strips of TH whole rows. A block measures strips of
//   one frame: all of them where it owns the frame (a small frame), else
//   the frame's next strip not yet taken, from a counter in device memory,
//   until none is left (a block's work depends on the region edges it
//   meets, so strips handed out as blocks finish balance the load; fixed
//   bands, one wave of them, left most SMs waiting for the busiest, and
//   short bands, several waves, paid each block's set-up and flushes many
//   times over). Each strip's label
//   rows, one halo row above and one below, and its intensity rows are
//   staged in shared memory by cp.async (16 B where a 16-B block lies in
//   the tensor, 4-B words or bytes at a ragged edge; async_copy.cuh), so
//   the perimeter's 3x3 neighbourhood and the column walk read shared
//   memory, and device memory is read once (the halo rows from L2).
// * A warp takes 256 consecutive pixels of a row, a thread 8 of them, held
//   in registers (two 16-B shared loads where the row allows). A warp whose
//   pixels all hold one label (most of a frame: the background, region 0,
//   is measured too) takes the fast path: count, x-sum, x-min and x-max in
//   closed form, only the intensity sums (and the perimeter units of a
//   foreground region) reduced over the warp, one lane adding them to the
//   block's accumulators. Only a warp that straddles a region edge runs
//   __match_any_sync: threads whose 8 pixels hold one label are merged by
//   it, the others add their runs of equal labels one by one.
// * Accumulators live in shared memory, 32-bit integers where a thread
//   adds to them: per (row of the strip, region) count, x-sum, x-min, x-max,
//   sum I and sum I*x; per region the perimeter units. When a strip ends,
//   its rows' sums go into per-region 64-bit sums of I, I*y and I*x (one
//   thread a region, no atomics: a 64-bit shared atomic is a loop of
//   compare-and-swaps). A block owns its rows and stores their partials
//   without atomics. Each column keeps its current run of equal labels in
//   shared memory across the block's strips and adds a finished run to the
//   column counts with one device-memory atomic.
// * The histogram: a warp whose 256 pixels hold one region and one
//   intensity adds them with one atomic; otherwise a thread adds its runs of
//   equal (region, intensity). The block's (R, 256) table packs two 16-bit
//   bins in a word (R x 512 B, so that two blocks fit an SM at R = 64; a
//   block takes at most 65535 pixels, so no bin overflows); at the block's
//   end the non-zero bins go to the output with integer atomics. Where the
//   table would not fit (large R), the counts go to the output directly.
// * Exact and deterministic: integer accumulators only. Per-thread and
//   per-warp sums are 32-bit where bounded (sum I*(x - x_warp) < 2^24; a
//   row's sum I*x < 2^32 while W <= 5803, beyond which it goes to the
//   region's 64-bit sum by a shared atomic), the per-region intensity sums
//   64-bit (sum I*x over a strip passes 2^32).
// * Outputs that several blocks add to (the sums, the column counts, the
//   histogram) and the strip counters are zeroed by one cudaMemsetAsync of
//   the caller's buffer; where a block owns a whole frame it zeroes them
//   itself and the memset is skipped.
//
// The entry point returns the first non-zero CUDA error code of its set-up
// and launch (0 = launched).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                 // consecutive pixels a thread
constexpr int kSpan = 32 * kPer;        // pixels of one row a warp takes at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kRowBits = (1u << (kPer + 2)) - 1;  // a thread's pixels and their two neighbours
constexpr size_t kTwoBlocks = 112 * 1024;  // shared bytes a block may take and leave two an SM
constexpr size_t kOneBlock = 232448;       // the 227 KB a block may use
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kHistShared = 48 * 1024;  // the packed table's budget
constexpr int kPacked = 65535;             // a 16-bit count's largest value
constexpr long long kBlockPixels = 16384;  // a block's least work, where the grid allows
constexpr int kRowIxMaxW = 5803;           // 255 * W * (W - 1) / 2 < 2^32: a row's sum I*x in 32 bits

struct Args {
  const int32_t* lab;
  const uint8_t* img;
  unsigned long long* sums;  // (B, R, 5)
  int32_t* rows;             // (4, B, H, R)
  int32_t* colcnt;           // (B, W, R)
  unsigned* hist;            // (B, R, 256)
  long long total;           // B * H * W
  long long plane;           // B * H * R
  int H, W, R;
  int TH;                    // rows a strip
  int strips;                // strips a frame: ceil(H / TH)
  int blocks;                // blocks a frame
  int cap;                   // strips a block takes at most
  int* next;                 // (B,): a frame's next strip to hand out (blocks > 1)
  int hist_shared;           // the packed table in shared memory
  int row_ix;                // sum I*x per (row, region) in 32 bits (W <= kRowIxMaxW)
  size_t lab_slot, img_slot;  // bytes a staged row takes
  size_t off_img, off_sums, off_hist, off_rows, off_col, off_units;
};

// The block's shared accumulators.
struct Acc {
  int32_t *cnt, *sumx, *minx, *maxx, *rowI;     // (TH, R)
  unsigned* rowIx;                              // (TH, R); null where it could overflow
  unsigned long long *sumI, *sumIy, *sumIx;     // (R,)
  unsigned *n1, *n065;                          // (R,)
  unsigned* col;                                // (W,): the column's run, (r + 1) << 16 | length
  unsigned* hist;                               // (R, 128) packed, or null
};

// One 2x2 block with corners a=(i-1,j-1), b=(i-1,j), c=(i,j-1), d=(i,j).
__device__ __forceinline__ void add_block(int a, int b, int c, int d, int& n1, int& n065) {
  const int count = a + b + c + d;
  if (count == 1 || count == 3) {
    n065 += 1;
  } else if (count == 2) {
    if (a == d) n065 += 2;  // a diagonal pair: two corner cuts
    else n1 += 1;
  }
}

// The perimeter units of the foreground pixel at bit j of the rows' masks
// (bit j-1 its left neighbour, j+1 its right): n1 | n065 << 8.
__device__ __forceinline__ unsigned units(unsigned up, unsigned mid, unsigned dn, int j) {
  const int nw = up >> (j - 1) & 1, n = up >> j & 1, ne = up >> (j + 1) & 1;
  const int w = mid >> (j - 1) & 1, e = mid >> (j + 1) & 1;
  const int sw = dn >> (j - 1) & 1, s = dn >> j & 1, se = dn >> (j + 1) & 1;
  int n1 = 0, n065 = 0;
  add_block(nw, n, w, 1, n1, n065);                     // block (y, x): corner d
  if (!e) add_block(n, ne, 1, e, n1, n065);             // block (y, x+1): corner c
  if (!sw && !s) add_block(w, 1, sw, s, n1, n065);      // block (y+1, x): corner b
  if (!e && !s && !se) add_block(1, e, s, se, n1, n065);  // block (y+1, x+1): corner a
  return static_cast<unsigned>(n1) | static_cast<unsigned>(n065) << 8;
}

// Foreground bits of row[x0 - 1 .. x0 + kPer] (bit 0 is x0 - 1): two 16-B
// loads where the thread's pixels are whole and aligned.
__device__ __forceinline__ unsigned fg_bits(const int32_t* row, int x0, int W) {
  unsigned m = 0;
  if (x0 + kPer <= W && (reinterpret_cast<uintptr_t>(row + x0) & 15) == 0) {
    const int4 v0 = *reinterpret_cast<const int4*>(row + x0);
    const int4 v1 = *reinterpret_cast<const int4*>(row + x0 + 4);
    m = (v0.x > 0) << 1 | (v0.y > 0) << 2 | (v0.z > 0) << 3 | (v0.w > 0) << 4 | (v1.x > 0) << 5 |
        (v1.y > 0) << 6 | (v1.z > 0) << 7 | (v1.w > 0) << 8;
    if (x0 > 0 && row[x0 - 1] > 0) m |= 1u;
    if (x0 + kPer < W && row[x0 + kPer] > 0) m |= 1u << (kPer + 1);
    return m;
  }
#pragma unroll
  for (int j = 0; j < kPer + 2; ++j) {
    const int x = x0 - 1 + j;
    if (x >= 0 && x < W && row[x] > 0) m |= 1u << j;
  }
  return m;
}

// A run of region r in row yl: its pixel count, x-sum, x-extremes,
// intensity sums and perimeter units, into the block's accumulators.
template <bool I>
__device__ __forceinline__ void add_run(const Acc& s, int yl, int R, int r, int cnt, int sumx, int minx,
                                        int maxx, unsigned si, unsigned long long six, unsigned n1,
                                        unsigned n065) {
  const int k = yl * R + r;
  atomicAdd(&s.cnt[k], cnt);
  atomicAdd(&s.sumx[k], sumx);
  atomicMin(&s.minx[k], minx);
  atomicMax(&s.maxx[k], maxx);
  if (I && si) {
    atomicAdd(&s.rowI[k], static_cast<int>(si));
    if (s.rowIx) {
      atomicAdd(&s.rowIx[k], static_cast<unsigned>(six));
    } else {
      atomicAdd(&s.sumIx[r], six);
    }
  }
  if (n1) atomicAdd(&s.n1[r], n1);
  if (n065) atomicAdd(&s.n065[r], n065);
}

// n pixels of region r with intensity c.
__device__ __forceinline__ void hist_add(const Acc& s, unsigned* g, int r, int c, unsigned n) {
  if (s.hist) {
    atomicAdd(&s.hist[r * 128 + (c >> 1)], (c & 1) ? n << 16 : n);
  } else {
    atomicAdd(&g[r * 256 + c], n);
  }
}

// One warp on the pixels [xs, xs + kSpan) of strip row yl (Lm; Lu and Ld
// the rows above and below, null beyond the frame; V its intensity).
template <bool P, bool I>
__device__ __forceinline__ void measure_span(const Args& a, const Acc& s, unsigned* ghist,
                                             const int32_t* Lu, const int32_t* Lm, const int32_t* Ld,
                                             const uint8_t* V, int yl, int xs, int lane) {
  const int W = a.W, R = a.R;
  const int xe = min(W, xs + kSpan);
  const int x0 = xs + lane * kPer;
  const int n_in = max(0, min(kPer, xe - x0));

  int lab[kPer];
  unsigned iv[kPer];
  if (n_in == kPer && (reinterpret_cast<uintptr_t>(Lm + x0) & 15) == 0) {
    const int4 v0 = *reinterpret_cast<const int4*>(Lm + x0);
    const int4 v1 = *reinterpret_cast<const int4*>(Lm + x0 + 4);
    lab[0] = v0.x, lab[1] = v0.y, lab[2] = v0.z, lab[3] = v0.w;
    lab[4] = v1.x, lab[5] = v1.y, lab[6] = v1.z, lab[7] = v1.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) lab[k] = k < n_in ? Lm[x0 + k] : -1;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) iv[k] = 0;
  if (I) {
    if (n_in == kPer && (reinterpret_cast<uintptr_t>(V + x0) & 7) == 0) {
      const uint2 v = *reinterpret_cast<const uint2*>(V + x0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        iv[k] = v.x >> (8 * k) & 0xff;
        iv[k + 4] = v.y >> (8 * k) & 0xff;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) iv[k] = k < n_in ? V[x0 + k] : 0u;
    }
  }

  // Region keys (-1: not measured), the thread's key (-2: mixed, -3: no
  // pixel), and whether the warp's pixels all hold one key.
  int key[kPer];
  bool mixed = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    key[k] = (k < n_in && lab[k] >= 0 && lab[k] < R) ? lab[k] : -1;
    if (k < n_in && key[k] != key[0]) mixed = true;
  }
  const int t_key = n_in == 0 ? -3 : (mixed ? -2 : key[0]);
  const int k0 = __shfl_sync(kFull, t_key, 0);
  const bool uni = __all_sync(kFull, t_key == k0 || t_key == -3) && k0 != -2;

  if (P) {
    // Perimeter units of the foreground pixels, from the 3x3 neighbourhood.
    unsigned pu[kPer];
    bool any_fg = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      pu[k] = 0;
      any_fg |= key[k] > 0;
    }
    if (any_fg) {
      unsigned mid = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) mid |= (k < n_in && lab[k] > 0) ? 2u << k : 0u;
      if (x0 > 0 && Lm[x0 - 1] > 0) mid |= 1u;
      if (x0 + kPer < W && Lm[x0 + kPer] > 0) mid |= 1u << (kPer + 1);
      const unsigned up = Lu ? fg_bits(Lu, x0, W) : 0u;
      const unsigned dn = Ld ? fg_bits(Ld, x0, W) : 0u;
      if (!(up == kRowBits && mid == kRowBits && dn == kRowBits)) {  // an interior has none
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (key[k] > 0) pu[k] = units(up, mid, dn, k + 1);
        }
      }
    }
    // The thread's sums (meaningful where its pixels hold one key).
    unsigned si = 0, sid = 0, un = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < n_in) {
        si += iv[k];
        sid += iv[k] * static_cast<unsigned>(x0 + k - xs);
        un += pu[k];
      }
    }
    if (uni) {
      if (k0 >= 0) {
        unsigned n1 = un & 0xff, n065 = un >> 8;
        if (I) {
          si = __reduce_add_sync(kFull, si);
          sid = __reduce_add_sync(kFull, sid);
        }
        if (k0 > 0) {
          n1 = __reduce_add_sync(kFull, n1);
          n065 = __reduce_add_sync(kFull, n065);
        }
        if (lane == 0) {
          const int cnt = xe - xs;
          add_run<I>(s, yl, R, k0, cnt, (xs + xe - 1) * cnt / 2, xs, xe - 1, si,
                     static_cast<unsigned long long>(xs) * si + sid, n1, n065);
        }
      }
    } else {
      // Threads of one key merge over the warp; mixed threads (unique
      // keys) and empty ones (key -1) form groups that add nothing here.
      const int mk = t_key >= -1 ? t_key : (t_key == -3 ? -1 : -4 - lane);
      const unsigned peers = __match_any_sync(kFull, mk);
      const bool one = t_key >= 0;
      const unsigned cnt = __reduce_add_sync(peers, one ? n_in : 0);
      const unsigned sumx = __reduce_add_sync(peers, one ? (2 * x0 + n_in - 1) * n_in / 2 : 0);
      const unsigned minx = __reduce_min_sync(peers, static_cast<unsigned>(x0));
      const unsigned maxx = __reduce_max_sync(peers, static_cast<unsigned>(x0 + n_in - 1));
      const unsigned gsi = I ? __reduce_add_sync(peers, si) : 0u;
      const unsigned gsid = I ? __reduce_add_sync(peers, sid) : 0u;
      const unsigned n1 = __reduce_add_sync(peers, un & 0xff);
      const unsigned n065 = __reduce_add_sync(peers, un >> 8);
      if (one && lane == __ffs(peers) - 1) {
        add_run<I>(s, yl, R, mk, cnt, sumx, minx, maxx, gsi, static_cast<unsigned long long>(xs) * gsi + gsid,
                   n1, n065);
      }
      if (t_key == -2) {  // the thread's runs of equal keys
        int from = 0;
        unsigned rsi = 0, rsid = 0, ru = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (k < n_in) {
            rsi += iv[k];
            rsid += iv[k] * static_cast<unsigned>(x0 + k - xs);
            ru += pu[k];
            if (k == n_in - 1 || key[k + 1 < kPer ? k + 1 : k] != key[k]) {
              if (key[k] >= 0) {
                const int c = k + 1 - from;
                add_run<I>(s, yl, R, key[k], c, (2 * (x0 + from) + c - 1) * c / 2, x0 + from, x0 + k, rsi,
                           static_cast<unsigned long long>(xs) * rsi + rsid, ru & 0xff, ru >> 8);
              }
              from = k + 1;
              rsi = rsid = ru = 0;
            }
          }
        }
      }
    }
  }

  if (I) {
    if (uni && k0 >= 0) {  // one region: one intensity too?
      bool one_bin = true;
#pragma unroll
      for (int k = 1; k < kPer; ++k) one_bin &= k >= n_in || iv[k] == iv[0];
      const int t_bin = n_in == 0 ? -3 : (one_bin ? static_cast<int>(iv[0]) : -2);
      const int b0 = __shfl_sync(kFull, t_bin, 0);
      if (__all_sync(kFull, t_bin == b0 || t_bin == -3) && b0 >= 0) {
        if (lane == 0) hist_add(s, ghist, k0, b0, static_cast<unsigned>(xe - xs));
        return;
      }
    }
    unsigned run = 0;  // the thread's runs of equal (region, intensity)
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < n_in && key[k] >= 0) {
        ++run;
        const int n = k + 1 < kPer ? k + 1 : k;
        if (k == n_in - 1 || key[n] != key[k] || iv[n] != iv[k]) {
          hist_add(s, ghist, key[k], static_cast<int>(iv[k]), run);
          run = 0;
        }
      }
    }
  }
}

// The label row y of frame f as staged in slot t (its place in the slot
// follows the row's address modulo 16).
__device__ __forceinline__ const int32_t* staged_lab(const Args& a, char* sm, int t, int f, int y) {
  return in_slot<const int32_t>(sm + t * a.lab_slot, a.lab + (static_cast<long long>(f) * a.H + y) * a.W);
}

__device__ __forceinline__ const uint8_t* staged_img(const Args& a, char* sm, int yl, int f, int y) {
  return in_slot<const uint8_t>(sm + a.off_img + yl * a.img_slot,
                                a.img + (static_cast<long long>(f) * a.H + y) * a.W);
}

// Each warp copies whole rows in turn: label rows y0 - 1 .. y0 + rows into
// slots 0 .. rows + 1 (the halo rows only for the perimeter, and only
// inside the frame), intensity rows y0 .. y0 + rows - 1.
template <bool P, bool I>
__device__ void stage(const Args& a, char* sm, int f, int y0, int rows, int warp, int lane) {
  const char* l0 = reinterpret_cast<const char*>(a.lab);
  const char* i0 = reinterpret_cast<const char*>(a.img);
  const int nl = rows + 2;
  const int tasks = nl + (I ? rows : 0);
  for (int t = warp; t < tasks; t += kWarps) {
    const long long frame_row = static_cast<long long>(f) * a.H;
    if (t < nl) {
      const int y = y0 - 1 + t;
      if (y < 0 || y >= a.H || (!P && (t == 0 || t == nl - 1))) continue;
      copy_span(sm + t * a.lab_slot, reinterpret_cast<const char*>(a.lab + (frame_row + y) * a.W),
                4 * static_cast<size_t>(a.W), l0, l0 + 4 * a.total, lane);
    } else {
      const int yl = t - nl;
      copy_span(sm + a.off_img + yl * a.img_slot, reinterpret_cast<const char*>(a.img + (frame_row + y0 + yl) * a.W),
                static_cast<size_t>(a.W), i0, i0 + a.total, lane);
    }
  }
}

// The column's finished run into the column counts.
__device__ __forceinline__ void flush_col(int32_t* col, int x, int R, unsigned st) {
  const int r = static_cast<int>(st >> 16) - 1;
  if (r >= 0) atomicAdd(&col[static_cast<long long>(x) * R + r], static_cast<int>(st & 0xffff));
}

template <bool P, bool I>
__global__ void __launch_bounds__(kThreads, 2) measure_kernel(Args a) {
  extern __shared__ __align__(16) char sm[];
  const int H = a.H, W = a.W, R = a.R;
  __shared__ int s_strip;
  const int f = blockIdx.x / a.blocks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Acc s{};
  if (P) {
    int32_t* rows = reinterpret_cast<int32_t*>(sm + a.off_rows);
    const int n = a.TH * R;
    s.cnt = rows, s.sumx = rows + n, s.minx = rows + 2 * n, s.maxx = rows + 3 * n, s.rowI = rows + 4 * n;
    if (I && a.row_ix) s.rowIx = reinterpret_cast<unsigned*>(rows + 5 * n);
    s.col = reinterpret_cast<unsigned*>(sm + a.off_col);
    s.n1 = reinterpret_cast<unsigned*>(sm + a.off_units);
    s.n065 = s.n1 + R;
    if (I) {
      s.sumI = reinterpret_cast<unsigned long long*>(sm + a.off_sums);
      s.sumIy = s.sumI + R;
      s.sumIx = s.sumIy + R;
    }
  }
  if (I && a.hist_shared) s.hist = reinterpret_cast<unsigned*>(sm + a.off_hist);

  unsigned long long* gsums = P ? a.sums + static_cast<long long>(f) * R * 5 : nullptr;
  int32_t* gcol = P ? a.colcnt + static_cast<long long>(f) * W * R : nullptr;
  unsigned* ghist = I ? a.hist + static_cast<long long>(f) * R * 256 : nullptr;
  if (a.blocks == 1) {  // the block owns the frame's outputs: it zeroes them
    if (P) {
      for (int i = tid; i < 5 * R; i += kThreads) gsums[i] = 0;
      for (long long i = tid; i < static_cast<long long>(W) * R; i += kThreads) gcol[i] = 0;
    }
    if (I) {
      for (int i = tid; i < 256 * R; i += kThreads) ghist[i] = 0;
    }
  }
  if (P) {
    for (int x = tid; x < W; x += kThreads) s.col[x] = 0;
    for (int r = tid; r < R; r += kThreads) {
      s.n1[r] = s.n065[r] = 0;
      if (I) s.sumI[r] = s.sumIy[r] = s.sumIx[r] = 0;
    }
  }
  if (s.hist) {
    uint4* h4 = reinterpret_cast<uint4*>(s.hist);  // 16-B aligned: R x 512 B
    for (int i = tid; i < 32 * R; i += kThreads) h4[i] = make_uint4(0, 0, 0, 0);
  }

  const int segs = (W + kSpan - 1) / kSpan;
  for (int taken = 0;; ++taken) {
    // The next strip: in order where the block owns the frame, else the
    // frame's next one not yet taken (blocks that meet many region edges
    // take fewer strips).
    if (tid == 0) {
      s_strip = a.blocks == 1 ? taken : (taken < a.cap ? atomicAdd(&a.next[f], 1) : a.strips);
    }
    __syncthreads();
    if (s_strip >= a.strips) break;
    const int y0 = s_strip * a.TH;
    const int rows = min(a.TH, H - y0);
    if (P) {
      for (int i = tid; i < rows * R; i += kThreads) {
        s.cnt[i] = 0;
        s.sumx[i] = 0;
        s.minx[i] = W;
        s.maxx[i] = -1;
        if (I) s.rowI[i] = 0;
        if (s.rowIx) s.rowIx[i] = 0;
      }
    }
    stage<P, I>(a, sm, f, y0, rows, warp, lane);
    copies_wait_all();
    __syncthreads();

    for (int t = warp; t < rows * segs; t += kWarps) {
      const int yl = t / segs, y = y0 + yl;
      const int32_t* Lm = staged_lab(a, sm, yl + 1, f, y);
      const int32_t* Lu = P && y > 0 ? staged_lab(a, sm, yl, f, y - 1) : nullptr;
      const int32_t* Ld = P && y + 1 < H ? staged_lab(a, sm, yl + 2, f, y + 1) : nullptr;
      const uint8_t* V = I ? staged_img(a, sm, yl, f, y) : nullptr;
      measure_span<P, I>(a, s, ghist, Lu, Lm, Ld, V, yl, (t % segs) * kSpan, lane);
    }
    __syncthreads();

    if (P) {
      for (int x = tid; x < W; x += kThreads) {  // the columns' runs
        unsigned st = s.col[x];
        for (int yl = 0; yl < rows; ++yl) {
          const int l = staged_lab(a, sm, yl + 1, f, y0 + yl)[x];
          const unsigned r1 = (l >= 0 && l < R) ? static_cast<unsigned>(l + 1) : 0u;
          if ((st >> 16) == r1) {
            ++st;
          } else {
            flush_col(gcol, x, R, st);
            st = r1 << 16 | 1u;
          }
        }
        s.col[x] = st;
      }
      const long long row0 = (static_cast<long long>(f) * H + y0) * R;
      for (int i = tid; i < rows * R; i += kThreads) {  // the strip's rows: this block's alone
        a.rows[row0 + i] = s.cnt[i];
        a.rows[a.plane + row0 + i] = s.sumx[i];
        a.rows[2 * a.plane + row0 + i] = s.minx[i];
        a.rows[3 * a.plane + row0 + i] = s.maxx[i];
      }
      if (I) {
        for (int r = tid; r < R; r += kThreads) {
          unsigned long long si = 0, siy = 0, six = 0;
          for (int yl = 0; yl < rows; ++yl) {
            const unsigned v = static_cast<unsigned>(s.rowI[yl * R + r]);
            si += v;
            siy += static_cast<unsigned long long>(v) * (y0 + yl);
            if (s.rowIx) six += s.rowIx[yl * R + r];
          }
          s.sumI[r] += si;
          s.sumIy[r] += siy;
          s.sumIx[r] += six;
        }
      }
    }
    __syncthreads();
  }

  if (P) {
    for (int x = tid; x < W; x += kThreads) flush_col(gcol, x, R, s.col[x]);
    for (int r = tid; r < R; r += kThreads) {
      unsigned long long* g = gsums + 5 * r;
      if (s.n1[r]) atomicAdd(&g[0], static_cast<unsigned long long>(s.n1[r]));
      if (s.n065[r]) atomicAdd(&g[1], static_cast<unsigned long long>(s.n065[r]));
      if (I && s.sumI[r]) {
        atomicAdd(&g[2], s.sumI[r]);
        atomicAdd(&g[3], s.sumIy[r]);
        atomicAdd(&g[4], s.sumIx[r]);
      }
    }
  }
  if (s.hist) {
    const uint4* h4 = reinterpret_cast<const uint4*>(s.hist);
    for (int i = tid; i < 32 * R; i += kThreads) {
      const uint4 q = h4[i];
      if ((q.x | q.y | q.z | q.w) == 0) continue;
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
      unsigned* g = ghist + (i >> 5) * 256 + 8 * (i & 31);  // bins 8i .. 8i+7 of region i / 32
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (w[k] & 0xffff) atomicAdd(&g[2 * k], w[k] & 0xffff);
        if (w[k] >> 16) atomicAdd(&g[2 * k + 1], w[k] >> 16);
      }
    }
  }
}

// ---- the device-memory route -----------------------------------------------
//
// Where no strip fits (a large R or a wide row) or the launcher's limits
// are passed (R >= 2^15: the column run's 16-bit region; W > 2^16), the
// accumulators live in device memory and every block adds to them with
// integer atomics, so any R and W are taken:
// * A warp takes a task: up to kGlobalRows rows of one span of kSpan
//   columns of one frame, row by row, each lane 8 consecutive pixels, read
//   from device memory (the 3x3 neighbourhood of the perimeter from L1 /
//   L2). A task's rows shrink until the frames give kTaskWarps warps of
//   tasks an SM (a warp's rows run one after another, so a few tall tasks
//   would leave most of the card idle).
// * Equal labels are merged first, as on the shared route: a warp whose
//   span holds one region adds its row partials with one lane's atomics
//   (closed-form count and x-sums), else __match_any_sync merges the
//   threads of one region and mixed threads add their runs. A uniform
//   span's region sums (intensity, perimeter units) stay in lane 0's
//   registers while the next rows' spans hold the same region, so the
//   background, measured too, hits its sums once a task, not once a row.
// * Each lane keeps its 8 columns' current runs of equal regions in
//   registers through the task's rows and adds a finished run to the
//   column counts with one atomic.
// * Row partials: count and x-min / x-max by 32-bit atomics (x-min and
//   x-max start at W and -1: init_rows_kernel writes the four row planes
//   first), the row x-sum 32-bit where W <= 65536 (W (W - 1) / 2 < 2^31),
//   else 64-bit into its own (B, H, R) buffer; the region sums and the
//   perimeter units 64-bit; the histogram 32-bit. Integer atomics only:
//   exact and deterministic.
// Bound: device memory. It reads the labels and the intensity once and
// writes the partials: the row planes twice (initialised, then added to),
// the sums, the column counts and the histogram once, zeroed by the
// launcher's memset; a row's atomics and its neighbours' reads hit L2.

constexpr int kGlobalRows = 16;       // rows of a warp's task at most
constexpr int kTaskWarps = 32;        // tasks an SM the task height aims at
constexpr int kGlobalMaxW = 1 << 16;  // beyond it a row's x-sum needs 64 bits

struct GArgs {
  const int32_t* lab;
  const uint8_t* img;
  unsigned long long* sums;    // (B, R, 5)
  int32_t* rows;               // (4, B, H, R)
  unsigned long long* sumx64;  // (B, H, R) row x-sums where W > kGlobalMaxW, else null
  int32_t* colcnt;             // (B, W, R)
  unsigned* hist;              // (B, R, 256)
  long long plane;             // B * H * R
  long long tasks;             // B * bands * segs
  int H, W, R;
  int task_rows;               // rows of a task
  int bands, segs;             // tasks a frame: ceil(H / task_rows) x ceil(W / kSpan)
};

__global__ void __launch_bounds__(kThreads) init_rows_kernel(int32_t* rows, long long plane, int W) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < plane;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    rows[i] = 0;
    rows[plane + i] = 0;
    rows[2 * plane + i] = W;
    rows[3 * plane + i] = -1;
  }
}

// A run of region r in row y of frame f: its row partials.
__device__ __forceinline__ void row_add(const GArgs& a, long long fy, int r, int cnt, long long sumx, int minx,
                                        int maxx) {
  const long long k = fy * a.R + r;
  atomicAdd(&a.rows[k], cnt);
  if (a.sumx64) {
    atomicAdd(&a.sumx64[k], static_cast<unsigned long long>(sumx));
  } else {
    atomicAdd(&a.rows[a.plane + k], static_cast<int>(sumx));
  }
  atomicMin(&a.rows[2 * a.plane + k], minx);
  atomicMax(&a.rows[3 * a.plane + k], maxx);
}

// Region r's perimeter units and intensity sums (I, I*y, I*x).
template <bool I>
__device__ __forceinline__ void region_add(unsigned long long* g, unsigned long long n1, unsigned long long n065,
                                           unsigned long long si, unsigned long long siy, unsigned long long six) {
  if (n1) atomicAdd(&g[0], n1);
  if (n065) atomicAdd(&g[1], n065);
  if (I && si) {
    atomicAdd(&g[2], si);
    atomicAdd(&g[3], siy);
    atomicAdd(&g[4], six);
  }
}

template <bool P, bool I>
__device__ void measure_task(const GArgs& a, int f, int y0, int xs, int lane) {
  const int H = a.H, W = a.W, R = a.R;
  const int y1 = min(H, y0 + a.task_rows);
  const int xe = min(W, xs + kSpan);
  const int x0 = xs + lane * kPer;
  const int n_in = max(0, min(kPer, xe - x0));
  unsigned long long* gsums = P ? a.sums + static_cast<long long>(f) * R * 5 : nullptr;
  int32_t* gcol = P ? a.colcnt + static_cast<long long>(f) * W * R : nullptr;
  unsigned* ghist = I ? a.hist + static_cast<long long>(f) * R * 256 : nullptr;

  int run_r[kPer], run_n[kPer];  // each column's current run: region + 1 (0: none) and length
#pragma unroll
  for (int k = 0; k < kPer; ++k) run_r[k] = run_n[k] = 0;
  // Lane 0: the region sums of uniform spans of region acc_r (-1: none).
  int acc_r = -1;
  unsigned long long acc_n1 = 0, acc_n065 = 0, acc_si = 0, acc_siy = 0, acc_six = 0;

  for (int y = y0; y < y1; ++y) {
    const long long fy = static_cast<long long>(f) * H + y;
    const int32_t* Lm = a.lab + fy * W;
    const uint8_t* V = I ? a.img + fy * W : nullptr;
    int lab[kPer];
    unsigned iv[kPer];
    if (n_in == kPer && (reinterpret_cast<uintptr_t>(Lm + x0) & 15) == 0) {
      const int4 v0 = __ldg(reinterpret_cast<const int4*>(Lm + x0));
      const int4 v1 = __ldg(reinterpret_cast<const int4*>(Lm + x0 + 4));
      lab[0] = v0.x, lab[1] = v0.y, lab[2] = v0.z, lab[3] = v0.w;
      lab[4] = v1.x, lab[5] = v1.y, lab[6] = v1.z, lab[7] = v1.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) lab[k] = k < n_in ? Lm[x0 + k] : -1;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) iv[k] = 0;
    if (I) {
      if (n_in == kPer && (reinterpret_cast<uintptr_t>(V + x0) & 7) == 0) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(V + x0));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          iv[k] = v.x >> (8 * k) & 0xff;
          iv[k + 4] = v.y >> (8 * k) & 0xff;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) iv[k] = k < n_in ? V[x0 + k] : 0u;
      }
    }
    int key[kPer];
    bool mixed = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      key[k] = (k < n_in && lab[k] >= 0 && lab[k] < R) ? lab[k] : -1;
      if (k < n_in && key[k] != key[0]) mixed = true;
    }
    const int t_key = n_in == 0 ? -3 : (mixed ? -2 : key[0]);
    const int k0 = __shfl_sync(kFull, t_key, 0);
    const bool uni = __all_sync(kFull, t_key == k0 || t_key == -3) && k0 != -2;

    if (P) {
      unsigned pu[kPer];
      bool any_fg = false;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        pu[k] = 0;
        any_fg |= key[k] > 0;
      }
      if (any_fg) {
        unsigned mid = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) mid |= (k < n_in && lab[k] > 0) ? 2u << k : 0u;
        if (x0 > 0 && Lm[x0 - 1] > 0) mid |= 1u;
        if (x0 + kPer < W && Lm[x0 + kPer] > 0) mid |= 1u << (kPer + 1);
        const unsigned up = y > 0 ? fg_bits(Lm - W, x0, W) : 0u;
        const unsigned dn = y + 1 < H ? fg_bits(Lm + W, x0, W) : 0u;
        if (!(up == kRowBits && mid == kRowBits && dn == kRowBits)) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            if (key[k] > 0) pu[k] = units(up, mid, dn, k + 1);
          }
        }
      }
      // The thread's sums, x relative to xs (meaningful where its pixels
      // hold one key).
      unsigned si = 0, sid = 0, un = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k < n_in) {
          si += iv[k];
          sid += iv[k] * static_cast<unsigned>(x0 + k - xs);
          un += pu[k];
        }
      }
      if (uni) {
        if (k0 >= 0) {
          unsigned n1 = un & 0xff, n065 = un >> 8;
          if (I) {
            si = __reduce_add_sync(kFull, si);
            sid = __reduce_add_sync(kFull, sid);
          }
          if (k0 > 0) {
            n1 = __reduce_add_sync(kFull, n1);
            n065 = __reduce_add_sync(kFull, n065);
          }
          if (lane == 0) {
            const int cnt = xe - xs;
            row_add(a, fy, k0, cnt, static_cast<long long>(xs) * cnt + static_cast<long long>(cnt) * (cnt - 1) / 2,
                    xs, xe - 1);
            if (acc_r != k0) {
              if (acc_r >= 0) region_add<I>(gsums + 5 * static_cast<long long>(acc_r), acc_n1, acc_n065, acc_si,
                                            acc_siy, acc_six);
              acc_r = k0;
              acc_n1 = acc_n065 = acc_si = acc_siy = acc_six = 0;
            }
            acc_n1 += n1;
            acc_n065 += n065;
            acc_si += si;
            acc_siy += static_cast<unsigned long long>(y) * si;
            acc_six += static_cast<unsigned long long>(xs) * si + sid;
          }
        }
      } else {
        const int mk = t_key >= -1 ? t_key : (t_key == -3 ? -1 : -4 - lane);
        const unsigned peers = __match_any_sync(kFull, mk);
        const bool one = t_key >= 0;
        const int cnt = static_cast<int>(__reduce_add_sync(peers, one ? n_in : 0));
        const unsigned sxr = __reduce_add_sync(peers, one ? (2 * (x0 - xs) + n_in - 1) * n_in / 2 : 0);
        const unsigned minx = __reduce_min_sync(peers, static_cast<unsigned>(x0));
        const unsigned maxx = __reduce_max_sync(peers, static_cast<unsigned>(x0 + n_in - 1));
        const unsigned gsi = I ? __reduce_add_sync(peers, si) : 0u;
        const unsigned gsid = I ? __reduce_add_sync(peers, sid) : 0u;
        const unsigned n1 = __reduce_add_sync(peers, un & 0xff);
        const unsigned n065 = __reduce_add_sync(peers, un >> 8);
        if (one && lane == __ffs(peers) - 1) {
          row_add(a, fy, mk, cnt, static_cast<long long>(xs) * cnt + sxr, static_cast<int>(minx),
                  static_cast<int>(maxx));
          region_add<I>(gsums + 5 * static_cast<long long>(mk), n1, n065, gsi, static_cast<unsigned long long>(y) * gsi,
                        static_cast<unsigned long long>(xs) * gsi + gsid);
        }
        if (t_key == -2) {  // the thread's runs of equal keys
          int from = 0;
          unsigned rsi = 0, rsid = 0, ru = 0;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            if (k < n_in) {
              rsi += iv[k];
              rsid += iv[k] * static_cast<unsigned>(x0 + k - xs);
              ru += pu[k];
              if (k == n_in - 1 || key[k + 1 < kPer ? k + 1 : k] != key[k]) {
                if (key[k] >= 0) {
                  const int c = k + 1 - from;
                  row_add(a, fy, key[k], c, static_cast<long long>(x0 + from) * c + c * (c - 1) / 2, x0 + from,
                          x0 + k);
                  region_add<I>(gsums + 5 * static_cast<long long>(key[k]), ru & 0xff, ru >> 8, rsi,
                                static_cast<unsigned long long>(y) * rsi,
                                static_cast<unsigned long long>(xs) * rsi + rsid);
                }
                from = k + 1;
                rsi = rsid = ru = 0;
              }
            }
          }
        }
      }
      // The columns' runs.
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k < n_in) {
          const int r1 = key[k] + 1;  // 0: not measured
          if (r1 == run_r[k]) {
            ++run_n[k];
          } else {
            if (run_r[k]) atomicAdd(&gcol[static_cast<long long>(x0 + k) * R + run_r[k] - 1], run_n[k]);
            run_r[k] = r1;
            run_n[k] = 1;
          }
        }
      }
    }

    if (I) {
      bool done = false;
      if (uni && k0 >= 0) {  // one region: one intensity too?
        bool one_bin = true;
#pragma unroll
        for (int k = 1; k < kPer; ++k) one_bin &= k >= n_in || iv[k] == iv[0];
        const int t_bin = n_in == 0 ? -3 : (one_bin ? static_cast<int>(iv[0]) : -2);
        const int b0 = __shfl_sync(kFull, t_bin, 0);
        if (__all_sync(kFull, t_bin == b0 || t_bin == -3) && b0 >= 0) {
          if (lane == 0) atomicAdd(&ghist[static_cast<long long>(k0) * 256 + b0], static_cast<unsigned>(xe - xs));
          done = true;
        }
      }
      if (!done) {
        unsigned run = 0;  // the thread's runs of equal (region, intensity)
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (k < n_in && key[k] >= 0) {
            ++run;
            const int n = k + 1 < kPer ? k + 1 : k;
            if (k == n_in - 1 || key[n] != key[k] || iv[n] != iv[k]) {
              atomicAdd(&ghist[static_cast<long long>(key[k]) * 256 + iv[k]], run);
              run = 0;
            }
          }
        }
      }
    }
  }

  if (P) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (run_r[k]) atomicAdd(&gcol[static_cast<long long>(x0 + k) * R + run_r[k] - 1], run_n[k]);
    }
    if (lane == 0 && acc_r >= 0) {
      region_add<I>(gsums + 5 * static_cast<long long>(acc_r), acc_n1, acc_n065, acc_si, acc_siy, acc_six);
    }
  }
}

// Each warp takes tasks (frame, band of rows, span) in turn.
template <bool P, bool I>
__global__ void __launch_bounds__(kThreads, 2) measure_global_kernel(GArgs a) {
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; t < a.tasks; t += stride) {
    const int seg = static_cast<int>(t % a.segs);
    const long long fb = t / a.segs;
    const int band = static_cast<int>(fb % a.bands);
    const int f = static_cast<int>(fb / a.bands);
    measure_task<P, I>(a, f, band * a.task_rows, seg * kSpan, lane);
  }
}

template <bool P, bool I>
int launch_global(const GArgs& a, int sms, cudaStream_t stream) {
  const long long want = (a.tasks + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(std::max(1LL, std::min<long long>(want, 8LL * sms)));
  measure_global_kernel<P, I><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory offsets of a block for strips of a.TH rows; returns the bytes.
size_t layout(Args& a, bool P, bool I) {
  const size_t R = a.R, TH = a.TH;
  size_t off = (TH + 2) * a.lab_slot;
  a.off_img = off;
  if (I) off += TH * a.img_slot;
  a.off_sums = off;
  if (P && I) off += round16(3 * R * sizeof(unsigned long long));
  a.off_hist = off;
  if (a.hist_shared) off += R * 128 * sizeof(unsigned);
  a.off_rows = off;
  if (P) off += round16((I ? 5 + a.row_ix : 4) * TH * R * sizeof(int32_t));
  a.off_col = off;
  if (P) off += round16(static_cast<size_t>(a.W) * sizeof(unsigned));
  a.off_units = off;
  if (P) off += round16(2 * R * sizeof(unsigned));
  return off;
}

// The strip height: the tallest of 16, 8, 4 rows that leaves two blocks an
// SM, else the tallest that fits one; the packed table needs a strip of at
// most 65535 pixels, so it is given up before no strip fits. Returns the
// shared bytes, 0 if nothing fits.
size_t choose_strip(Args& a, bool P, bool I) {
  const int two[] = {16, 8, 4}, one[] = {16, 8, 4, 2, 1};
  a.hist_shared = I && static_cast<size_t>(a.R) * 128 * sizeof(unsigned) <= kHistShared;
  for (;;) {
    auto fits = [&](int th, size_t budget) {
      if (a.hist_shared && static_cast<long long>(th) * a.W > kPacked) return false;
      a.TH = th;
      return layout(a, P, I) <= budget;
    };
    for (int th : two) {
      if (fits(th, kTwoBlocks)) return layout(a, P, I);
    }
    for (int th : one) {
      if (fits(th, kOneBlock)) return layout(a, P, I);
    }
    if (!a.hist_shared) return 0;
    a.hist_shared = 0;
  }
}

template <bool P, bool I>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t e =
        cudaFuncSetAttribute(measure_kernel<P, I>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  measure_kernel<P, I><<<static_cast<unsigned>(B) * a.blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lab: (B, H, W) int32; img: (B, H, W) uint8 or null (no intensity sums, no
// histogram); sums: (B, R, 5) int64, rows: (4, B, H, R) int32 and colcnt:
// (B, W, R) int32, all null for the histogram alone; hist: (B, R, 256)
// int32, null exactly when img is. All contiguous. sums, colcnt and hist
// lie in `zero` (zero_bytes bytes, its last 4 * B bytes the strip
// counters), which is zeroed here unless each block owns a frame.
// `strip` is the route the caller's plan chose
// (ops/region_histogram.py:region_measure_plan): the strip height of the
// shared-memory route, or 0 for the device-memory route; a route the
// launcher would not choose itself is refused. On the device-memory route
// with the partials and W > 65536 the row x-sums go to sumx64 ((B, H, R)
// int64 in `zero`), else sumx64 is null.
extern "C" int region_measure_launch(const void* lab, const void* img, void* sums, void* rows, void* colcnt,
                                     void* hist, void* sumx64, void* zero, long long zero_bytes, int B, int H,
                                     int W, int R, int strip, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const bool P = sums != nullptr, I = img != nullptr;
  if (R <= 0 || (!P && !I) || I != (hist != nullptr) || (P && (rows == nullptr || colcnt == nullptr)) ||
      zero == nullptr || zero_bytes < 4LL * B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.lab = static_cast<const int32_t*>(lab);
  a.img = static_cast<const uint8_t*>(img);
  a.sums = static_cast<unsigned long long*>(sums);
  a.rows = static_cast<int32_t*>(rows);
  a.colcnt = static_cast<int32_t*>(colcnt);
  a.hist = static_cast<unsigned*>(hist);
  a.total = static_cast<long long>(B) * H * W;
  a.plane = static_cast<long long>(B) * H * R;
  a.H = H, a.W = W, a.R = R;
  a.row_ix = W <= kRowIxMaxW;
  a.lab_slot = round16(4 * static_cast<size_t>(W) + 32);
  a.img_slot = round16(static_cast<size_t>(W) + 32);
  // The shared-memory route where R and W are within its limits and a
  // strip fits; else the device-memory route.
  const size_t smem = R < (1 << 15) && W <= (1 << 16) ? choose_strip(a, P, I) : 0;
  if (strip != (smem ? a.TH : 0)) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (smem == 0) {
    if ((sumx64 != nullptr) != (P && W > kGlobalMaxW)) return static_cast<int>(cudaErrorInvalidValue);
    GArgs g{};
    g.lab = a.lab, g.img = a.img, g.sums = a.sums, g.rows = a.rows, g.colcnt = a.colcnt, g.hist = a.hist;
    g.sumx64 = static_cast<unsigned long long*>(sumx64);
    g.plane = a.plane;
    g.H = H, g.W = W, g.R = R;
    g.segs = (W + kSpan - 1) / kSpan;
    const long long row_tasks = static_cast<long long>(B) * H * g.segs;
    const long long fill_rows = row_tasks / (static_cast<long long>(kTaskWarps) * sms);
    g.task_rows = static_cast<int>(std::max(1LL, std::min<long long>(kGlobalRows, fill_rows)));
    g.bands = (H + g.task_rows - 1) / g.task_rows;
    g.tasks = static_cast<long long>(B) * g.bands * g.segs;
    e = cudaMemsetAsync(zero, 0, static_cast<size_t>(zero_bytes), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (P) {
      const long long want = (a.plane + kThreads - 1) / kThreads;
      init_rows_kernel<<<static_cast<unsigned>(std::max(1LL, std::min<long long>(want, 8LL * sms))), kThreads, 0,
                         st>>>(a.rows, a.plane, W);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (P && I) return launch_global<true, true>(g, sms, st);
    if (P) return launch_global<true, false>(g, sms, st);
    return launch_global<false, true>(g, sms, st);
  }
  if (sumx64 != nullptr) return static_cast<int>(cudaErrorInvalidValue);

  // Blocks a frame: enough for two an SM over the batch, but no more than
  // one for each kBlockPixels of the frame, and enough to take every strip
  // when each takes at most `cap` (a column's run length and, with the
  // packed table, a block's pixels stay within 65535). At loki's (8, 1024,
  // 1280) 33 blocks a frame share its 128 strips; a crop of the threshold
  // path's (256, 64, 128) bucket is one block's.
  a.strips = (H + a.TH - 1) / a.TH;
  a.cap = kPacked / a.TH;
  if (a.hist_shared) a.cap = std::min<int>(a.cap, kPacked / (a.TH * W));
  const long long fill = (2LL * sms + B - 1) / B;
  const long long work = (static_cast<long long>(H) * W + kBlockPixels - 1) / kBlockPixels;
  long long blocks = std::max((a.strips + a.cap - 1) / a.cap, static_cast<int>(std::min(fill, work)));
  blocks = std::max(1LL, std::min<long long>(blocks, a.strips));
  a.blocks = static_cast<int>(blocks);
  if (static_cast<long long>(B) * a.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);

  if (a.blocks > 1) {
    a.next = reinterpret_cast<int*>(static_cast<char*>(zero) + zero_bytes) - B;
    e = cudaMemsetAsync(zero, 0, static_cast<size_t>(zero_bytes), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (P && I) return launch<true, true>(a, B, smem, st);
  if (P) return launch<true, false>(a, B, smem, st);
  return launch<false, true>(a, B, smem, st);
}
