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
// whose (N, T, K, 2, 2) row states the card never holds. Bound: bytes, p
// and the labels read once and the (num_cells, T, K, 2, 2) state written
// once. Design: one thread per entry (neighbouring threads on neighbouring
// columns of a row), the bin by a binary search over the thresholds in
// shared memory, one global atomic into a zeroed (num_cells, T+1, K, 2)
// histogram (a cell's histogram is too large to keep per block); a second
// launch takes each (cell, column, y) prefix over the bins and writes
// below / total - below.
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
    int target64, Shape s, int* __restrict__ g_hist, unsigned* __restrict__ tickets, int* __restrict__ state) {
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
cudaError_t launch(const float* p, const float* thr, const void* target, int target64, Shape s, int* scratch,
                   int* state, size_t smem, cudaStream_t stream) {
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
  kernel<<<dim3(static_cast<unsigned>(per_tile), tiles, 1), kThreads, smem, stream>>>(p, thr, target, target64, s, g_hist,
                                                                                    tickets, state);
  return cudaGetLastError();
}

template <int VEC, bool LABELS, bool UNIFORM>
cudaError_t dispatch_smem(const float* p, const float* thr, const void* target, int target64, Shape s, int* scratch,
                          int* state, cudaStream_t stream) {
  // the widest tile (a power of two, up to kMaxTile columns) whose packed
  // histogram fits beside the thresholds; none fits: global memory
  const size_t thr_bytes = (static_cast<size_t>(s.T) + 3) * sizeof(float);  // padded with three NaN
  for (int ltw = s.ltw; ltw >= (VEC == 4 ? 2 : 0); --ltw) {
    const size_t hist_bytes = (static_cast<size_t>(s.T) + 1) * ((1u << ltw) + 1) * sizeof(unsigned);
    if (thr_bytes + hist_bytes <= kHistSmemLimit) {
      s.ltw = ltw;
      return launch<VEC, LABELS, UNIFORM, true, true>(p, thr, target, target64, s, scratch, state,
                                                      thr_bytes + hist_bytes, stream);
    }
  }
  if (thr_bytes <= kDefaultSmem)
    return launch<VEC, LABELS, UNIFORM, false, true>(p, thr, target, target64, s, scratch, state, thr_bytes, stream);
  return launch<VEC, LABELS, UNIFORM, false, false>(p, thr, target, target64, s, scratch, state, 0, stream);
}

template <int VEC>
cudaError_t dispatch_mode(const float* p, const float* thr, const void* target, int target64, int labels, int uniform,
                          Shape s, int* scratch, int* state, cudaStream_t stream) {
  if (labels) {
    return uniform ? dispatch_smem<VEC, true, true>(p, thr, target, target64, s, scratch, state, stream)
                   : dispatch_smem<VEC, true, false>(p, thr, target, target64, s, scratch, state, stream);
  }
  return uniform ? dispatch_smem<VEC, false, true>(p, thr, target, target64, s, scratch, state, stream)
                 : dispatch_smem<VEC, false, false>(p, thr, target, target64, s, scratch, state, stream);
}

// ------------------------------------------------------------ segmented mode

constexpr int kSegThreads = 256;

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
  const long long lanes = static_cast<long long>(num_cells) * K * 2;
  binned_curve_prefix_kernel<<<static_cast<unsigned>((lanes + kSegThreads - 1) / kSegThreads), kSegThreads, 0, stream>>>(
      hist, num_cells, K, T, state);
  return cudaGetLastError();
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
  int ltw = 0;
  while ((1 << ltw) < kMaxTile && (1 << ltw) < k) ++ltw;
  Shape s{n, k, t, ltw, 0, lo, scale};
  const auto* p_ = static_cast<const float*>(p);
  const auto* thr_ = static_cast<const float*>(thr);
  auto* scratch_ = static_cast<int*>(scratch);
  auto* state_ = static_cast<int*>(state);
  auto stream_ = static_cast<cudaStream_t>(stream);
  if (vec4 && ltw >= 2)
    return dispatch_mode<4>(p_, thr_, target, target64, labels, uniform, s, scratch_, state_, stream_);
  return dispatch_mode<1>(p_, thr_, target, target64, labels, uniform, s, scratch_, state_, stream_);
}

// p, thr, target and labels as binned_curve_state takes them; cells: (n,)
// int32, each row's cohort cell or -1 (dropped); hist: (num_cells, t + 1,
// k, 2) int32, zeroed; state: (num_cells, t, k, 2, 2) int32.
extern "C" int binned_curve_state_segmented(const void* p, const void* thr, const void* target, int target64,
                                            int labels, const void* cells, long long n, int k, int t, int num_cells,
                                            void* hist, void* state, void* stream) {
  if (k == 0 || t == 0 || num_cells == 0) return 0;
  const auto* p_ = static_cast<const float*>(p);
  const auto* thr_ = static_cast<const float*>(thr);
  const auto* cells_ = static_cast<const int*>(cells);
  auto* hist_ = static_cast<int*>(hist);
  auto* state_ = static_cast<int*>(state);
  auto stream_ = static_cast<cudaStream_t>(stream);
  if (target64) {
    const auto* tg = static_cast<const long long*>(target);
    return labels ? launch_segmented<true>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_)
                  : launch_segmented<false>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_);
  }
  const auto* tg = static_cast<const int*>(target);
  return labels ? launch_segmented<true>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_)
                : launch_segmented<false>(p_, thr_, tg, cells_, n, k, t, num_cells, hist_, state_, stream_);
}
