// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// binned_curve_state: the binned multi-threshold confusion state of the
// precision-recall curve family, in one launch, by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/classification/precision_recall_curve.py
//   ::_binned_curve_state with ::_threshold_bins (its bucketize formulation).
//   The JAX package has no Pallas kernel for it (the retired
//   ops/binned_confusion.py::binned_confusion_counts_pallas did the same job).
//
// Computes, over an (N, K) float32 tensor p and T thresholds sorted
// ascending (any NaN last), the (T, K, 2, 2) int32 state
//   state[t, k, y, 0] = #{n : y_nk == y, p_nk <  thr[t]}
//   state[t, k, y, 1] = #{n : y_nk == y, p_nk >= thr[t]}
// over the entries whose target is not negative. Two target modes:
//   labels: target (N,) int32 or int64 class indices; y = (min(target, K-1) == k),
//           the one-hot of the clipped label the JAX package builds;
//   binary: target (N, K) int32 or int64; y = min(target, 1).
// An int64 target is read as it is and cut to int32 (static_cast<int>),
// as astype(jnp.int32) cuts it. Each entry falls in bin
// b = #{t : thr[t] <= p}; NaN lands in bin 0 and +inf in bin T, as
// _threshold_bins rules. The state is a prefix over bins of the
// (bin, k, y) histogram: state[t, k, y, 0] = sum of bins 0..t.
//
// Bound on the card: bytes. Each probability is read once (4 bytes), the
// labels once (4 bytes per row), and the state is written once: at
// 65536 x 64, T = 128, about 17.1 MB, 5.1 us at 3.35 TB/s. The O(1) bin index
// costs a few operations per element, far below the card's rate. Tensor
// cores buy nothing here: the TPU's MXU contraction needs an N x K x T
// compare tensor built first, while the histogram reads each probability
// once. TMA buys little too: the stream is read once, and coalesced 16-byte
// loads, several rows ahead per thread, keep enough bytes in flight.
//
// Design:
// - Column tiles: block (x, y) counts columns [y*tw, y*tw + tw) of a range
//   of rows, tw = 16 at K = 64 (64 bytes of each 256-byte row), with
//   float4 loads where K % 4 == 0, else scalars, two rows ahead per
//   thread, columns past K masked, rows walked with shifts and no
//   division. A row's label is read once per thread. Two blocks per SM,
//   all resident at once (the launch bounds hold each thread to 64
//   registers), keep enough loads in flight.
// - A private histogram in shared memory: (T+1) x tw bins, each one 32-bit
//   word packing the y=0 count (low 16 bits) and the y=1 count (high 16
//   bits), 8.5 KB at T = 128; a block counts at most 65535 rows, so neither
//   half overflows. One shared atomic per entry; a histogram row has
//   tw + 1 words, so lanes counting one column into different bins hit
//   different banks.
// - The bin index: on a grid where _uniform_bin_margin_ok holds (decided
//   once on the host, where the grid is fixed), an affine candidate
//   trunc((p - lo) * scale) and three ordered compares, JAX's exact path;
//   on any other grid a binary search over the thresholds in shared memory.
// - Merge: each block adds its non-zero packed bins into the global
//   (bin, column, y) histogram, one 64-bit atomic per bin for both halves.
//   A merge over distributed shared memory in thread-block clusters was
//   built and measured on the H100 first; it was slower at every cluster
//   size tried (clusters of 512-thread blocks also left a tail wave), so
//   the blocks merge straight into global memory.
// - Epilogue: the last block of a column tile, found by an atomic ticket in
//   the zeroed scratch, splits each column's bins into segments, one thread
//   each (neighbouring lanes on neighbouring columns, a segment's loads
//   issued together and kept in registers), sums them, takes the prefix
//   over segments in shared memory, and writes below / total - below
//   straight into the (T, K, 2, 2) state, one 16-byte store per (threshold,
//   column).
// - Large shapes: where no tile of at least 4 columns (1 for scalar loads)
//   fits its histogram in 100 KB of shared memory, the blocks count with
//   atomics straight into the global histogram, and where the thresholds
//   exceed 48 KB they are read from global memory.
// - A row mask, for K1s at one cell: where `cells` is given, a row of cell
//   -1 counts nowhere (K1's own entry passes none).
// Launches on the caller's stream, allocates nothing (the caller zeroes the
// scratch: the global histogram and one ticket per column tile) and returns
// the launch's error.
//
// binned_curve_state_segmented (K1s), the sliced plan's mode: the same state
// per cohort cell, (num_cells, T, K, 2, 2) int32, each row's entries
// counted into the cell that slice_assign gave it (cells (N,) int32; a row
// with cell -1 is dropped), in both target modes. Replaces JAX's per-row
// vmap of _binned_curve_state followed by segment_sum over the cells
// (torchmetrics_tpu/parallel/sliced.py ::_row_states and ::_segment_reduce),
// whose (N, T, K, 2, 2) row states the card never holds; the StateGuard's
// mask calls it with one cell and its refused rows as cell -1
// (robustness/guard.py ::_mask_apply).
// Bound: bytes, p and the labels (and cells) read once and the
// (num_cells, T, K, 2, 2) state written once: 16.8 MB + 0.5 MB + 33.6 MB at
// 65536 x 64, T = 128 into 256 cells, 15.2 us at 3.35 TB/s; at one cell
// the state is 0.26 MB and the bound 5.2 us, K1's.
// Design:
// - One cell: K1 itself, with the cells as a row mask (a row of cell -1
//   counts nowhere): the packed shared histogram, K1's grid, its epilogue
//   writing the state. No sort, no prefix launch.
// - More cells (up to 4096), where K1's histogram fits shared memory: a
//   counting sort of the row indices by cell in two launches (each block of
//   4096 rows counts its cells in shared memory; then each block takes its
//   places from those counts and scatters its rows into order[] through
//   shared cursors, cell -1 dropping out; no global atomics, which queue on
//   a few hot counters), then a fixed grid of (blocks, column
//   tiles), the same for every batch of a shape, walks order[] in equal
//   ranges of at most 65535 rows. Each block counts its range into K1's
//   packed (T+1) x tw histogram in shared memory, with K1's affine or
//   searched bin index, and adds the non-zero bins into the cell's global
//   (T+1, K, 2) histogram, one 64-bit atomic per bin, whenever the cell
//   changes in its range and at its end. A prefix launch, one thread per
//   (cell, column, y), then writes below / total - below. The prefix stays a
//   launch of its own: a block's range spans several cells, and a cell's
//   bins come from several blocks, so no block knows when a cell is whole.
// - Thresholds too many for the shared histogram (K1's 100 KB limit), or
//   more than 4096 cells: one thread per entry, the bin by binary search,
//   one global atomic into the zeroed histogram, then the prefix launch.
#include <math_constants.h>

#include <algorithm>

#include "_launch.cuh"

namespace {

using hist_launch::kDefaultSmem;
using hist_launch::kMaxDevices;
using hist_launch::kThreads;
using hist_launch::LaunchCache;

constexpr int kUnroll = 2;                     // rows loaded ahead per thread
constexpr int kMaxTile = 16;                   // columns per tile
constexpr int kBlocksPerSm = 2;                // blocks of the grid per SM, all resident at once
constexpr long long kMaxPackedCount = 65535;   // a 16-bit half of a packed bin
constexpr size_t kHistSmemLimit = 100 * 1024;  // two blocks per SM still fit
constexpr int kEpilogueBatch = 8;              // bins an epilogue thread loads at once

// #{t : thr[t] <= v}. UNIFORM: the affine candidate and three ordered
// compares (exact where the host checked the grid's margins); PADDED: thr
// has three NaN entries past T, which no value clears, so +inf lands in bin
// T with no bounds check. Otherwise a binary search. A NaN value compares
// false everywhere (and converts to k = 0), so it lands in bin 0 on every
// path; so do NaN thresholds, sorted last.
template <bool UNIFORM, bool PADDED>
__device__ __forceinline__ int bin_of(float v, const float* thr, int T, float lo, float scale) {
  if (UNIFORM) {
    int k = __float2int_rz((v - lo) * scale);  // saturates; NaN -> 0
    k = min(max(k, 0), T - 1);
    int b = k;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int j = k + d;
      b += (PADDED || j < T) && v >= thr[j] ? 1 : 0;
    }
    return b;
  }
  int l = 0, h = T;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (thr[mid] <= v) l = mid + 1; else h = mid;
  }
  return l;
}

struct Shape {
  long long n;  // rows
  int K;        // columns
  int T;        // thresholds
  int ltw;      // log2 of the tile width
  long long rows_per_block;
  float lo, scale;  // the affine bin index (UNIFORM only)
};

template <int VEC, bool LABELS, bool UNIFORM, bool HIST_SMEM, bool THR_SMEM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) binned_curve_state_kernel(
    const float* __restrict__ p, const float* __restrict__ thr_global, const void* __restrict__ target_raw,
    int target64, const int* __restrict__ cells, Shape s, int* __restrict__ g_hist, unsigned* __restrict__ tickets,
    int* __restrict__ state) {
  extern __shared__ int smem[];
  __shared__ int2 s_seg[kThreads];  // the epilogue's per-segment sums
  __shared__ bool s_last;
  const int K = s.K, T = s.T, tw = 1 << s.ltw;
  float* s_thr = reinterpret_cast<float*>(smem);
  // (T+1) x tw bins, each packing the y=0 count (low 16 bits) and the y=1
  // count (high 16 bits); rows of tw + 1 words, so that the lanes counting
  // one column into different bins hit different banks
  unsigned* s_hist = reinterpret_cast<unsigned*>(smem + (THR_SMEM ? T + 3 : 0));
  const int stride = tw + 1;
  const int n_bins = (T + 1) << s.ltw;
  if (THR_SMEM) {
    for (int i = threadIdx.x; i < T + 3; i += blockDim.x) s_thr[i] = i < T ? thr_global[i] : CUDART_NAN_F;
  }
  if (HIST_SMEM) {
    for (int i = threadIdx.x; i < (T + 1) * stride; i += blockDim.x) s_hist[i] = 0u;
  }
  __syncthreads();
  const float* thr = THR_SMEM ? s_thr : thr_global;
  const auto* t32 = static_cast<const int*>(target_raw);
  const auto* t64 = static_cast<const long long*>(target_raw);

  // ------------------------------------------------------------ count
  const int tile = blockIdx.y;
  const int col0 = tile << s.ltw;
  const int lvpr = s.ltw - (VEC == 4 ? 2 : 0);  // log2(column vectors per tile row)
  const int c_first = col0 + (threadIdx.x & ((1 << lvpr) - 1)) * VEC;  // this thread's first column
  const int rows_per_step = blockDim.x >> lvpr;
  const long long r_begin = static_cast<long long>(blockIdx.x) * s.rows_per_block;
  const long long r_end = min(s.n, r_begin + s.rows_per_block);
  if (c_first < K) {
    for (long long r0 = r_begin + (threadIdx.x >> lvpr); r0 < r_end; r0 += static_cast<long long>(rows_per_step) * kUnroll) {
      float4 vals[kUnroll];
      int lab[kUnroll];  // labels: the clipped class index, -1 masks the row
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r0 + static_cast<long long>(u) * rows_per_step;
        lab[u] = -1;
        vals[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < r_end) {
          const float* src = p + row * K + c_first;
          if (VEC == 4) vals[u] = __ldcs(reinterpret_cast<const float4*>(src));
          else vals[u].x = __ldcs(src);
          lab[u] = !LABELS ? 0 : min(target64 ? static_cast<int>(t64[row]) : t32[row], K - 1);
          if (cells != nullptr && cells[row] < 0) lab[u] = -1;  // K1s at one cell: a dropped row
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (lab[u] < 0) continue;  // past the range, or a masked row
        const long long row = r0 + static_cast<long long>(u) * rows_per_step;
        const float v4[4] = {vals[u].x, vals[u].y, vals[u].z, vals[u].w};
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int c = c_first + j;
          int y;
          if (LABELS) {
            y = lab[u] == c;
          } else {
            const long long at = row * K + c;
            const int t = target64 ? static_cast<int>(t64[at]) : t32[at];
            if (t < 0) continue;  // a masked entry
            y = t > 0;
          }
          const int b = bin_of<UNIFORM, THR_SMEM>(v4[j], thr, T, s.lo, s.scale);
          if (HIST_SMEM) atomicAdd(&s_hist[b * stride + (c - col0)], y ? 0x10000u : 1u);
          else atomicAdd(&g_hist[(static_cast<long long>(b) * K + c) * 2 + y], 1);
        }
      }
    }
  }

  // ------------------------------------------------------------ merge
  if (HIST_SMEM) {
    __syncthreads();
    // global bins are (bin, column, y) int32 pairs: one 64-bit atomic adds both halves of a packed bin
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
      const unsigned w = s_hist[(i >> s.ltw) * stride + (i & (tw - 1))];
      const int col = col0 + (i & (tw - 1));
      if (w == 0u || col >= K) continue;
      auto* pair = reinterpret_cast<unsigned long long*>(g_hist + (static_cast<long long>(i >> s.ltw) * K + col) * 2);
      atomicAdd(pair, static_cast<unsigned long long>(w & 0xffffu) | (static_cast<unsigned long long>(w >> 16) << 32));
    }
  }

  // ------------------------------------------------------------ epilogue
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[tile], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of the tile: thread (c, seg) owns bins [seg*L, seg*L + L)
  // of column col0 + c; segment sums, then a prefix over segments, then each
  // thread writes its bins' state, the lanes of a warp on neighbouring columns
  const int n_seg = min(32, static_cast<int>(blockDim.x) >> s.ltw);
  const int c = threadIdx.x & (tw - 1), seg = threadIdx.x >> s.ltw;
  const int col = col0 + c;
  const int L = (T + n_seg) / n_seg;  // ceil((T + 1) / n_seg)
  const int b0 = seg * L, b1 = min(b0 + L, T + 1);
  const bool mine = seg < n_seg && col < K;
  const int2* g2 = reinterpret_cast<const int2*>(g_hist);
  int2 v[kEpilogueBatch];  // loads issued together: one trip to L2 per batch
  const auto load = [&](int base, int stop) {
#pragma unroll
    for (int i = 0; i < kEpilogueBatch; ++i)
      v[i] = base + i < stop ? __ldcg(g2 + static_cast<long long>(base + i) * K + col) : make_int2(0, 0);
  };
  int2 sum = make_int2(0, 0);
  if (mine) {
    for (int base = b0; base < b1; base += kEpilogueBatch) {
      load(base, b1);
#pragma unroll
      for (int i = 0; i < kEpilogueBatch; ++i) {
        sum.x += v[i].x;
        sum.y += v[i].y;
      }
    }
  }
  s_seg[threadIdx.x] = sum;
  __syncthreads();
  if (!mine) return;
  int2 below = make_int2(0, 0), total = make_int2(0, 0);
  for (int q = 0; q < n_seg; ++q) {
    const int2 w = s_seg[(q << s.ltw) + c];
    if (q < seg) {
      below.x += w.x;
      below.y += w.y;
    }
    total.x += w.x;
    total.y += w.y;
  }
  int4* out = reinterpret_cast<int4*>(state);  // state[t, col, :, :] is one int4
  const int b_stop = min(b1, T);
  for (int base = b0; base < b_stop; base += kEpilogueBatch) {
    if (b1 - b0 > kEpilogueBatch) load(base, b_stop);  // a one-batch segment is still in v
#pragma unroll
    for (int i = 0; i < kEpilogueBatch; ++i) {
      below.x += v[i].x;  // entries in bins 0..b: p < thr[b]
      below.y += v[i].y;
      if (base + i < b_stop)
        out[static_cast<long long>(base + i) * K + col] = make_int4(below.x, total.x - below.x, below.y, total.y - below.y);
    }
  }
}

template <int VEC, bool LABELS, bool UNIFORM, bool HIST_SMEM, bool THR_SMEM>
cudaError_t launch(const float* p, const float* thr, const void* target, int target64, const int* cells, Shape s,
                   int* scratch, int* state, size_t smem, cudaStream_t stream) {
  auto kernel = binned_curve_state_kernel<VEC, LABELS, UNIFORM, HIST_SMEM, THR_SMEM>;
  static LaunchCache cache[kMaxDevices] = {};
  int sms = 0;
  cudaError_t err = hist_launch::prepare(kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  const int tw = 1 << s.ltw;
  const int tiles = (s.K + tw - 1) / tw;
  const long long rows_per_step = kThreads / (tw / VEC);
  // blocks per column tile: kBlocksPerSm per SM in all, at least one step of
  // rows each, and few enough rows that a packed 16-bit count cannot overflow
  long long per_tile = (static_cast<long long>(kBlocksPerSm) * sms + tiles - 1) / tiles;
  per_tile = std::min(per_tile, std::max(1LL, (s.n + rows_per_step - 1) / rows_per_step));
  if (HIST_SMEM) per_tile = std::max(per_tile, (s.n + kMaxPackedCount - 1) / kMaxPackedCount);
  s.rows_per_block = (s.n + per_tile - 1) / per_tile;
  int* g_hist = scratch;
  auto* tickets = reinterpret_cast<unsigned*>(scratch + static_cast<long long>(s.T + 1) * s.K * 2);
  kernel<<<dim3(static_cast<unsigned>(per_tile), tiles, 1), kThreads, smem, stream>>>(p, thr, target, target64, cells, s,
                                                                                    g_hist, tickets, state);
  return cudaGetLastError();
}

template <int VEC, bool LABELS, bool UNIFORM>
cudaError_t dispatch_smem(const float* p, const float* thr, const void* target, int target64, const int* cells, Shape s,
                          int* scratch, int* state, cudaStream_t stream) {
  // the widest tile (a power of two, up to kMaxTile columns) whose packed
  // histogram fits beside the thresholds; none fits: global memory
  const size_t thr_bytes = (static_cast<size_t>(s.T) + 3) * sizeof(float);  // padded with three NaN
  for (int ltw = s.ltw; ltw >= (VEC == 4 ? 2 : 0); --ltw) {
    const size_t hist_bytes = (static_cast<size_t>(s.T) + 1) * ((1u << ltw) + 1) * sizeof(unsigned);
    if (thr_bytes + hist_bytes <= kHistSmemLimit) {
      s.ltw = ltw;
      return launch<VEC, LABELS, UNIFORM, true, true>(p, thr, target, target64, cells, s, scratch, state,
                                                      thr_bytes + hist_bytes, stream);
    }
  }
  if (thr_bytes <= kDefaultSmem)
    return launch<VEC, LABELS, UNIFORM, false, true>(p, thr, target, target64, cells, s, scratch, state, thr_bytes, stream);
  return launch<VEC, LABELS, UNIFORM, false, false>(p, thr, target, target64, cells, s, scratch, state, 0, stream);
}

template <int VEC>
cudaError_t dispatch_mode(const float* p, const float* thr, const void* target, int target64, int labels, int uniform,
                          const int* cells, Shape s, int* scratch, int* state, cudaStream_t stream) {
  if (labels) {
    return uniform ? dispatch_smem<VEC, true, true>(p, thr, target, target64, cells, s, scratch, state, stream)
                   : dispatch_smem<VEC, true, false>(p, thr, target, target64, cells, s, scratch, state, stream);
  }
  return uniform ? dispatch_smem<VEC, false, true>(p, thr, target, target64, cells, s, scratch, state, stream)
                 : dispatch_smem<VEC, false, false>(p, thr, target, target64, cells, s, scratch, state, stream);
}

// K1 in one launch (the shape's tile width, float4 loads where they may be used).
cudaError_t binned_curve_state_launch(const void* p, const void* thr, const void* target, int target64, int labels,
                                      const int* cells, long long n, int k, int t, int uniform, float lo, float scale,
                                      int vec4, void* scratch, void* state, cudaStream_t stream) {
  int ltw = 0;
  while ((1 << ltw) < kMaxTile && (1 << ltw) < k) ++ltw;
  Shape s{n, k, t, ltw, 0, lo, scale};
  const auto* p_ = static_cast<const float*>(p);
  const auto* thr_ = static_cast<const float*>(thr);
  auto* scratch_ = static_cast<int*>(scratch);
  auto* state_ = static_cast<int*>(state);
  if (vec4 && ltw >= 2)
    return dispatch_mode<4>(p_, thr_, target, target64, labels, uniform, cells, s, scratch_, state_, stream);
  return dispatch_mode<1>(p_, thr_, target, target64, labels, uniform, cells, s, scratch_, state_, stream);
}

// ------------------------------------------------------------ segmented mode

constexpr int kSegThreads = 256;
constexpr int kSortThreads = 256;
constexpr int kSortRows = 4096;       // rows per block of the counting sort
constexpr int kMaxSortCells = 4096;   // cells the sort's shared counters hold
constexpr int kSortPerThread = kSortRows / kSortThreads;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Row u of this thread in its block's range of the counting sort.
__device__ __forceinline__ long long row_of(int u) {
  return static_cast<long long>(blockIdx.x) * kSortRows + threadIdx.x + static_cast<long long>(u) * kSortThreads;
}

// The cells of this thread's rows, all loads issued at once (-1 past n).
__device__ __forceinline__ void load_cells(const int* __restrict__ cells, long long n, int (&c)[kSortPerThread]) {
#pragma unroll
  for (int u = 0; u < kSortPerThread; ++u) c[u] = row_of(u) < n ? cells[row_of(u)] : -1;
}

// Counting sort, step 1: the rows of each cell in each block's range of
// kSortRows rows (cell -1 drops out), counted in shared memory; written to
// counts[cell * blocks + block].
__global__ void __launch_bounds__(kSortThreads) cell_count_kernel(const int* __restrict__ cells, long long n, int num_cells,
                                                                  int* __restrict__ counts) {
  __shared__ int s_count[kMaxSortCells];
  int cell[kSortPerThread];
  load_cells(cells, n, cell);
  for (int c = threadIdx.x; c < num_cells; c += blockDim.x) s_count[c] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSortPerThread; ++u) {
    if (cell[u] >= 0) atomicAdd(&s_count[cell[u]], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < num_cells; c += blockDim.x) counts[static_cast<long long>(c) * gridDim.x + blockIdx.x] = s_count[c];
}

// Counting sort, step 2: each block finds its place in each cell (the rows
// of the cells before it, all blocks, plus the cell's rows in the blocks
// before it) from the counts, then writes its rows' indices into order[],
// each at a place taken from a shared cursor (rows keep no order inside a
// cell: the counts do not need one). Block 0 writes each cell's offset and,
// at offsets[num_cells], every kept row.
__global__ void __launch_bounds__(kSortThreads) cell_scatter_kernel(const int* __restrict__ cells, long long n, int num_cells,
                                                                    const int* __restrict__ counts,
                                                                    int* __restrict__ offsets, int* __restrict__ order) {
  __shared__ int s_cursor[kMaxSortCells];
  __shared__ int s_total[kMaxSortCells];
  __shared__ int s_warp[kSortThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cell[kSortPerThread];
  load_cells(cells, n, cell);  // in flight while the places are worked out
  const int per = (num_cells + blockDim.x - 1) / blockDim.x;  // a thread's cells, contiguous
  const int c0 = threadIdx.x * per, c1 = min(num_cells, c0 + per);
  int sum = 0;
  for (int c = c0; c < c1; ++c) {
    const int* row = counts + static_cast<long long>(c) * gridDim.x;
    int total = 0, before = 0;
#pragma unroll 8
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      const int v = row[b];
      total += v;
      before += b < static_cast<int>(blockIdx.x) ? v : 0;
    }
    s_cursor[c] = before;
    s_total[c] = total;
    sum += total;
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w += u;
    }
    if (lane < kSortThreads / 32) s_warp[lane] = w;
  }
  __syncthreads();
  int run = (warp ? s_warp[warp - 1] : 0) + incl - sum;  // the rows of the cells before c0
  for (int c = c0; c < c1; ++c) {
    if (blockIdx.x == 0) offsets[c] = run;
    s_cursor[c] += run;
    run += s_total[c];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[num_cells] = s_warp[kSortThreads / 32 - 1];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSortPerThread; ++u) {
    if (cell[u] >= 0) order[atomicAdd(&s_cursor[cell[u]], 1)] = static_cast<int>(row_of(u));
  }
}

// The count over rows grouped by cell: block (x, y) walks positions
// [x * rows_per_block, ...) of order[] for the column tile y, counting into
// K1's packed histogram in shared memory, and adds its non-zero bins into
// the cell's global histogram (one 64-bit atomic a bin) each time the cell
// changes in its range and at its end. A range holds at most 65535 rows, so
// a 16-bit half never overflows.
template <int VEC, bool LABELS, bool UNIFORM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) binned_curve_cells_kernel(
    const float* __restrict__ p, const float* __restrict__ thr_global, const void* __restrict__ target_raw,
    int target64, const int* __restrict__ cells, const int* __restrict__ offsets, const int* __restrict__ order,
    int num_cells, Shape s, int* __restrict__ g_hist) {
  extern __shared__ int smem[];
  const int K = s.K, T = s.T, tw = 1 << s.ltw;
  float* s_thr = reinterpret_cast<float*>(smem);
  unsigned* s_hist = reinterpret_cast<unsigned*>(smem + T + 3);
  const int stride = tw + 1;
  const int n_bins = (T + 1) << s.ltw;
  for (int i = threadIdx.x; i < T + 3; i += blockDim.x) s_thr[i] = i < T ? thr_global[i] : CUDART_NAN_F;
  for (int i = threadIdx.x; i < (T + 1) * stride; i += blockDim.x) s_hist[i] = 0u;
  __syncthreads();
  const auto* t32 = static_cast<const int*>(target_raw);
  const auto* t64 = static_cast<const long long*>(target_raw);

  const int col0 = blockIdx.y << s.ltw;
  const int lvpr = s.ltw - (VEC == 4 ? 2 : 0);
  const int c_first = col0 + (threadIdx.x & ((1 << lvpr) - 1)) * VEC;
  const int rows_per_step = blockDim.x >> lvpr;
  const long long kept = offsets[num_cells];
  const long long r_begin = static_cast<long long>(blockIdx.x) * s.rows_per_block;
  const long long r_end = min(kept, r_begin + s.rows_per_block);
  long long seg = r_begin;
  int cell = seg < r_end ? cells[order[seg]] : 0;
  while (seg < r_end) {
    const long long seg_end = min(r_end, static_cast<long long>(offsets[cell + 1]));
    if (c_first < K) {
      for (long long r0 = seg + (threadIdx.x >> lvpr); r0 < seg_end; r0 += static_cast<long long>(rows_per_step) * kUnroll) {
        long long row[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long at = r0 + static_cast<long long>(u) * rows_per_step;
          row[u] = at < seg_end ? order[at] : -1;
        }
        float4 vals[kUnroll];
        int lab[kUnroll];  // labels: the clipped class index, -1 masks the row
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          lab[u] = -1;
          vals[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row[u] >= 0) {
            const float* src = p + row[u] * K + c_first;
            if (VEC == 4) vals[u] = __ldcs(reinterpret_cast<const float4*>(src));
            else vals[u].x = __ldcs(src);
            lab[u] = !LABELS ? 0 : min(target64 ? static_cast<int>(t64[row[u]]) : t32[row[u]], K - 1);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (lab[u] < 0) continue;
          const float v4[4] = {vals[u].x, vals[u].y, vals[u].z, vals[u].w};
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int c = c_first + j;
            int y;
            if (LABELS) {
              y = lab[u] == c;
            } else {
              const long long at = row[u] * K + c;
              const int t = target64 ? static_cast<int>(t64[at]) : t32[at];
              if (t < 0) continue;  // a masked entry
              y = t > 0;
            }
            const int b = bin_of<UNIFORM, true>(v4[j], s_thr, T, s.lo, s.scale);
            atomicAdd(&s_hist[b * stride + (c - col0)], y ? 0x10000u : 1u);
          }
        }
      }
    }
    __syncthreads();
    int* cell_hist = g_hist + static_cast<long long>(cell) * (T + 1) * K * 2;
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
      unsigned* word = &s_hist[(i >> s.ltw) * stride + (i & (tw - 1))];
      const unsigned w = *word;
      const int col = col0 + (i & (tw - 1));
      if (w == 0u || col >= K) continue;
      *word = 0u;
      auto* pair = reinterpret_cast<unsigned long long*>(cell_hist + (static_cast<long long>(i >> s.ltw) * K + col) * 2);
      atomicAdd(pair, static_cast<unsigned long long>(w & 0xffffu) | (static_cast<unsigned long long>(w >> 16) << 32));
    }
    __syncthreads();
    seg = seg_end;
    if (seg < r_end) cell = cells[order[seg]];
  }
}

template <bool LABELS, bool THR_SMEM, typename Tgt>
__global__ void __launch_bounds__(kSegThreads) binned_curve_segmented_kernel(
    const float* __restrict__ p, const float* __restrict__ thr_global, const Tgt* __restrict__ target,
    const int* __restrict__ cells, long long n, int K, int T, int* __restrict__ hist) {
  extern __shared__ float s_thr_seg[];
  const float* thr = THR_SMEM ? s_thr_seg : thr_global;
  if (THR_SMEM) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) s_thr_seg[i] = thr_global[i];
    __syncthreads();
  }
  const long long entries = n * K;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < entries; e += stride) {
    const long long row = e / K;
    const int col = static_cast<int>(e - row * K);
    const int cell = cells[row];
    if (cell < 0) continue;  // a spilled row
    const int t = static_cast<int>(target[LABELS ? row : e]);
    if (t < 0) continue;  // a masked entry
    const int y = LABELS ? ((t < K - 1 ? t : K - 1) == col) : (t < 1 ? t : 1);
    const int b = bin_of<false, false>(p[e], thr, T, 0.f, 0.f);
    atomicAdd(&hist[((static_cast<long long>(cell) * (T + 1) + b) * K + col) * 2 + y], 1);
  }
}

// state[cell, t, k, y] = (sum of bins 0..t, total - that sum)
__global__ void __launch_bounds__(kSegThreads) binned_curve_prefix_kernel(const int* __restrict__ hist, int num_cells,
                                                                         int K, int T, int* __restrict__ state) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(num_cells) * K * 2) return;
  const long long cell = i / (2LL * K);
  const int ky = static_cast<int>(i - cell * 2 * K);  // k * 2 + y
  const int* h = hist + cell * (T + 1) * K * 2 + ky;
  int total = 0;
  for (int b = 0; b <= T; ++b) total += h[static_cast<long long>(b) * K * 2];
  int below = 0;
  int2* out = reinterpret_cast<int2*>(state + cell * T * K * 4) + ky;
  for (int t = 0; t < T; ++t) {
    below += h[static_cast<long long>(t) * K * 2];
    out[static_cast<long long>(t) * K * 2] = make_int2(below, total - below);
  }
}

cudaError_t launch_prefix(const int* hist, int num_cells, int K, int T, int* state, cudaStream_t stream) {
  const long long lanes = static_cast<long long>(num_cells) * K * 2;
  binned_curve_prefix_kernel<<<static_cast<unsigned>((lanes + kSegThreads - 1) / kSegThreads), kSegThreads, 0, stream>>>(
      hist, num_cells, K, T, state);
  return cudaGetLastError();
}

template <bool LABELS, typename Tgt>
cudaError_t launch_segmented(const float* p, const float* thr, const Tgt* target, const int* cells, long long n, int K,
                             int T, int num_cells, int* hist, int* state, cudaStream_t stream) {
  const bool thr_smem = static_cast<size_t>(T) * sizeof(float) <= kDefaultSmem;
  auto kernel = thr_smem ? binned_curve_segmented_kernel<LABELS, true, Tgt> : binned_curve_segmented_kernel<LABELS, false, Tgt>;
  static LaunchCache cache[kMaxDevices] = {};
  int sms = 0;
  cudaError_t err = hist_launch::prepare(kernel, 0, cache, &sms);
  if (err != cudaSuccess) return err;
  const long long entries = n * K;
  const long long blocks = std::max(1LL, std::min(8LL * sms, (entries + kSegThreads - 1) / kSegThreads));
  const size_t smem = thr_smem ? static_cast<size_t>(T) * sizeof(float) : 0;
  if (entries > 0) {
    kernel<<<static_cast<unsigned>(blocks), kSegThreads, smem, stream>>>(p, thr, target, cells, n, K, T, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return launch_prefix(hist, num_cells, K, T, state, stream);
}


// The widest tile (a power of two from ltw down) whose packed histogram fits
// beside the padded thresholds, or -1: the cells route then takes the
// global atomics.
int cells_tile(int T, int ltw, int vec) {
  const size_t thr_bytes = (static_cast<size_t>(T) + 3) * sizeof(float);
  for (; ltw >= (vec == 4 ? 2 : 0); --ltw) {
    if (thr_bytes + (static_cast<size_t>(T) + 1) * ((1u << ltw) + 1) * sizeof(unsigned) <= kHistSmemLimit) return ltw;
  }
  return -1;
}

template <int VEC, bool LABELS, bool UNIFORM>
cudaError_t launch_cells(const float* p, const float* thr, const void* target, int target64, const int* cells,
                         const int* offsets, const int* order, int num_cells, Shape s, int* hist, cudaStream_t stream) {
  auto kernel = binned_curve_cells_kernel<VEC, LABELS, UNIFORM>;
  const size_t smem = ((static_cast<size_t>(s.T) + 3) + (static_cast<size_t>(s.T) + 1) * ((1u << s.ltw) + 1)) * 4;
  static LaunchCache cache[kMaxDevices] = {};
  int sms = 0;
  cudaError_t err = hist_launch::prepare(kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  const int tw = 1 << s.ltw;
  const int tiles = (s.K + tw - 1) / tw;
  const long long rows_per_step = kThreads / (tw / VEC);
  // a fixed grid: the ranges split all n positions, those past the kept rows count nothing
  long long per_tile = (static_cast<long long>(kBlocksPerSm) * sms + tiles - 1) / tiles;
  per_tile = std::min(per_tile, std::max(1LL, (s.n + rows_per_step - 1) / rows_per_step));
  per_tile = std::max(per_tile, (s.n + kMaxPackedCount - 1) / kMaxPackedCount);
  s.rows_per_block = (s.n + per_tile - 1) / per_tile;
  kernel<<<dim3(static_cast<unsigned>(per_tile), tiles, 1), kThreads, smem, stream>>>(p, thr, target, target64, cells,
                                                                                      offsets, order, num_cells, s, hist);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_cells(const float* p, const float* thr, const void* target, int target64, int labels, int uniform,
                           const int* cells, const int* offsets, const int* order, int num_cells, Shape s, int* hist,
                           cudaStream_t stream) {
  if (labels) {
    return uniform ? launch_cells<VEC, true, true>(p, thr, target, target64, cells, offsets, order, num_cells, s, hist, stream)
                   : launch_cells<VEC, true, false>(p, thr, target, target64, cells, offsets, order, num_cells, s, hist, stream);
  }
  return uniform ? launch_cells<VEC, false, true>(p, thr, target, target64, cells, offsets, order, num_cells, s, hist, stream)
                 : launch_cells<VEC, false, false>(p, thr, target, target64, cells, offsets, order, num_cells, s, hist, stream);
}

// K1s over more than one cell with the histogram in shared memory: the
// counting sort (two launches), the count, the prefix. sort: the cells'
// offsets (num_cells + 1), the rows' order (n), the blocks' counts
// (num_cells * ceil(n / kSortRows)).
cudaError_t launch_sorted(const float* p, const float* thr, const void* target, int target64, int labels, int uniform,
                          const int* cells, int num_cells, Shape s, int vec, int* hist, int* sort, int* state,
                          cudaStream_t stream) {
  int* offsets = sort;
  int* order = sort + num_cells + 1;
  int* counts = order + s.n;
  const auto blocks = static_cast<unsigned>((s.n + kSortRows - 1) / kSortRows);
  cell_count_kernel<<<blocks, kSortThreads, 0, stream>>>(cells, s.n, num_cells, counts);
  cell_scatter_kernel<<<blocks, kSortThreads, 0, stream>>>(cells, s.n, num_cells, counts, offsets, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = vec == 4 ? dispatch_cells<4>(p, thr, target, target64, labels, uniform, cells, offsets, order, num_cells, s, hist, stream)
                 : dispatch_cells<1>(p, thr, target, target64, labels, uniform, cells, offsets, order, num_cells, s, hist, stream);
  if (err != cudaSuccess) return err;
  return launch_prefix(hist, num_cells, s.K, s.T, state, stream);
}

}  // namespace

// p: (n, k) float32 contiguous; thr: (t,) float32 ascending; target: int32
// (target64 == 0) or int64, (n,) when labels != 0 else (n, k); uniform != 0:
// the affine bin index with lo and scale is exact on this grid; scratch:
// ((t + 1) * k * 2 + k) int32, zeroed; state: (t, k, 2, 2) int32.
// vec4: p's rows may be read as float4 (k % 4 == 0, p 16-byte aligned).
extern "C" int binned_curve_state(const void* p, const void* thr, const void* target, int target64, int labels,
                                  long long n, int k, int t, int uniform, float lo, float scale, int vec4,
                                  void* scratch, void* state, void* stream) {
  if (n == 0 || k == 0 || t == 0) return 0;
  return static_cast<int>(binned_curve_state_launch(p, thr, target, target64, labels, nullptr, n, k, t, uniform, lo, scale,
                                                    vec4, scratch, state, static_cast<cudaStream_t>(stream)));
}

// p, thr, target, labels and the grid (uniform, lo, scale) and vec4 as
// binned_curve_state takes them; cells: (n,) int32, each row's cohort cell
// or -1 (dropped); hist: num_cells * (t + 1) * k * 2 + k int32, zeroed (the
// histogram, then K1's tickets at one cell); sort: num_cells + 1 + n +
// num_cells * ceil(n / 4096) int32 (launch_sorted's; not read at one cell);
// state: (num_cells, t, k, 2, 2) int32.
extern "C" int binned_curve_state_segmented(const void* p, const void* thr, const void* target, int target64,
                                            int labels, const void* cells, long long n, int k, int t, int num_cells,
                                            int uniform, float lo, float scale, int vec4, void* hist, void* sort,
                                            void* state, void* stream) {
  if (k == 0 || t == 0 || num_cells == 0) return 0;
  const auto* p_ = static_cast<const float*>(p);
  const auto* thr_ = static_cast<const float*>(thr);
  const auto* cells_ = static_cast<const int*>(cells);
  auto* hist_ = static_cast<int*>(hist);
  auto* state_ = static_cast<int*>(state);
  auto stream_ = static_cast<cudaStream_t>(stream);
  if (num_cells == 1 && n > 0)  // K1 with the row mask: the state of one cell is K1's (t, k, 2, 2)
    return static_cast<int>(binned_curve_state_launch(p, thr, target, target64, labels, cells_, n, k, t, uniform, lo, scale,
                                                      vec4, hist, state, stream_));
  int ltw = 0;
  while ((1 << ltw) < kMaxTile && (1 << ltw) < k) ++ltw;
  const int vec = vec4 && ltw >= 2 ? 4 : 1;
  const int tile = n > 0 && num_cells <= kMaxSortCells ? cells_tile(t, ltw, vec) : -1;
  if (tile >= 0) {
    const Shape s{n, k, t, tile, 0, lo, scale};
    return static_cast<int>(launch_sorted(p_, thr_, target, target64, labels, uniform, cells_, num_cells, s, vec, hist_,
                                          static_cast<int*>(sort), state_, stream_));
  }
  // thresholds too many for the shared histogram: an atomic per entry into the global one
  if (target64) {
    const auto* tg = static_cast<const long long*>(target);
    return labels ? launch_segmented<true>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_)
                  : launch_segmented<false>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_);
  }
  const auto* tg = static_cast<const int*>(target);
  return labels ? launch_segmented<true>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_)
                : launch_segmented<false>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_);
}
