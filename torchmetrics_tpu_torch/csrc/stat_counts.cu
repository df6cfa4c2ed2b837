// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// stat_counts: the multiclass stat scores tp, fp, tn, fn of a batch, with the
// argmax of the scores fused in, in one launch, by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/classification/stat_scores.py
//   ::_multiclass_stat_scores_format (jnp.argmax(preds, axis=1)) with the
//   bincount branch of ::_multiclass_stat_scores_update (jnp.bincount
//   through torchmetrics_tpu/utilities/data.py::_bincount, then the diagonal
//   and the row and column sums of the confusion matrix). The JAX package
//   has no Pallas kernel for it.
//
// Computes the (4, C) int32 rows tp, fp, tn, fn from
//   scores: (N, C) float32; pred = jnp.argmax of the row: the first NaN if
//           the row has one, else the first maximum (-0 == 0), and 0 for a
//           row of -inf; or
//   labels: (N,) int32 or int64 class indices,
// and an (N,) int32 or int64 target; int64 is read as it is and cut to
// int32 (static_cast<int>), as astype(jnp.int32) cuts it. Each sample has
// the confusion-matrix index b = target * C + pred in int32 arithmetic that
// wraps as XLA's does, with jnp.bincount's semantics: b < 0 counts in bin 0
// and b >= C*C is dropped. With an ignore_index, samples whose target equals
// it are skipped and pred is first clamped to [0, C-1], as the JAX code
// does. Of the matrix M, tp = diag(M), fp = colsum - tp, fn = rowsum - tp and
// tn = sum(M) - rowsum - colsum + tp. These are linear in M, so each sample
// adds to them directly: (i, j) = (b / C, b % C) adds 1 to tp[i] if i == j,
// else 1 to fp[j] and fn[i]; it takes 1 from tn[i] and tn[j] (once if
// i == j), and adds 1 to the total that every tn[c] gets. Sums of these
// partials wrap mod 2^32 exactly as JAX's int32 sums do.
//
// Bound on the card: bytes. Each score is read once (4 bytes) and each label
// once: at N = 65536, C = 64, about 17.0 MB, 5.1 us at 3.35 TB/s. The compare
// per score is far below the card's rate.
//
// Design: a group of L lanes per row (L = 4 at C = 64) reads the row as
// float4 (scalars where C % 4 != 0) with neighbouring lanes on neighbouring
// 16 bytes, each lane reduces its share to (value, index) in registers, and
// the group reduces with warp shuffles. The group's first lane then adds the
// sample's partials into a (4, C) block-private array in shared memory
// (1 KB at C = 64) with shared atomics; at the end each block adds its
// partials, tn with the block's total, into the zeroed (4, C) output with
// atomics. No confusion matrix is built: the C x C histogram would cost each
// block 4*C*C bytes to zero and a C*C pass to reduce, for the same linear
// map. Where 4*C ints exceed 48 KB the samples add straight into the output.
// The labels mode runs the same kernel with one lane per row. Launches on
// the caller's stream, allocates nothing (the caller zeroes the output) and
// returns the launch's error.
//
// stat_counts_segmented (K2s), the sliced plan's mode: the same counts per
// cohort cell, (num_cells, 4, C) int32, each row's partials added into the
// cell that slice_assign gave it (cells (N,) int32; a row with cell -1 is
// dropped). Replaces JAX's per-row vmap of the bincount branch followed by
// segment_sum over the cells (torchmetrics_tpu/parallel/sliced.py
// ::_row_states and ::_segment_reduce): the counts are linear in the rows,
// so each row adds to its cell directly and no (N, 4, C) row state exists;
// the StateGuard's mask calls it with one cell and its refused rows as
// cell -1 (robustness/guard.py ::_mask_apply).
// Bound: bytes, the scores and labels (and cells) read once and the
// (num_cells, 4, C) output written once: 17.6 MB at 65536 x 64 into 256
// cells, 5.2 us at 3.35 TB/s; at one cell 5.2 us, K2's.
// Design:
// - One cell: K2 itself (stat_counts_kernel) with the cells as a row mask,
//   a row of cell -1 counting nowhere: K2's shared (4, C) partial, one
//   flush a block, one launch into the zeroed (1, 4, C) output.
// - More cells, where their counters fit a block's 227 KB: per cell only
//   three sums of rows are kept, the diagonal d, the row sums r (by target)
//   and the column sums q (by prediction), 3C counters of 16 bits, two a
//   word (98,304 bytes at 256 x 64, 49,152 at 1024 x 8; a block counts at
//   most 65535 rows). Every block holds the counters of all cells in shared
//   memory, walks its rows in order as K2 does (a lane group a row, the
//   argmax by shuffles), adds with shared atomics, and adds its non-zero
//   counters into a zeroed global copy. A second launch, a warp a cell,
//   derives tp = d, fp = q - d, fn = r - d, tn = total - r - q + d, total
//   the sum of r, and writes the output. Three device operations: the
//   copy's memset and the two launches.
//   A counting sort of the rows by cell and one flush a run of a cell (K1s's
//   route) was built beside it and timed on the H100 at 65536 x 64 into 256
//   cells and 8192 x 8 into 1024: slower at both, its two sort launches
//   alone near the counters' whole call. So the counters were kept.
// - More cells than fit (num_cells * 3C counters past 227 KB): one global
//   atomic per partial into the zeroed output and each cell's total in a
//   scratch, then a launch that adds each total to its tn row.
// Wrapping int32 adds throughout, as JAX's sums.
#include <math_constants.h>

#include <algorithm>

#include "_launch.cuh"

namespace {

using hist_launch::kDefaultSmem;
using hist_launch::kMaxDevices;
using hist_launch::kThreads;
using hist_launch::kWarps;
using hist_launch::LaunchCache;

constexpr int kUnroll = 2;                     // rows loaded ahead per lane group
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kCellSmemMax = 227 * 1024;    // the cell counters: the opt-in limit of a block on sm_90
constexpr size_t kSmSmem = 228 * 1024;         // shared memory of an SM
constexpr long long kMaxBlockRows = 65535;     // the rows a 16-bit cell counter holds

// jnp.argmax's order: NaN above every number, the lower index first among
// NaNs and among equal values (so -0 and 0 tie); (v, i) wins over (w, j)?
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  const bool nv = isnan(v), nw = isnan(w);
  if (nv || nw) return nv && (!nw || i < j);
  return v > w || (v == w && i < j);
}

// The prediction of `row`: the argmax of its scores over the row's group of
// L lanes (`sub` this lane's place; every lane of the group gets it, and
// every lane of the warp must call), or its label. A dead row gives junk.
template <bool SCORES, int VEC, typename Pred>
__device__ __forceinline__ int row_pred(const float* __restrict__ scores, const Pred* __restrict__ labels, long long row,
                                        bool live, int C, int L, int sub) {
  if (!SCORES) return live ? static_cast<int>(labels[row]) : 0;
  const int n_vec = VEC == 4 ? C >> 2 : C;  // vectors per row
  float best = -CUDART_INF_F;
  int arg = 0x7fffffff;  // loses every tie: a row of -inf gives index 0
  if (live) {
    const float* src = scores + row * C;
#pragma unroll 4
    for (int v = sub; v < n_vec; v += L) {
      if (VEC == 4) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(src) + v);
        const int i = v << 2;
        if (beats(x.x, i, best, arg)) { best = x.x; arg = i; }
        if (beats(x.y, i + 1, best, arg)) { best = x.y; arg = i + 1; }
        if (beats(x.z, i + 2, best, arg)) { best = x.z; arg = i + 2; }
        if (beats(x.w, i + 3, best, arg)) { best = x.w; arg = i + 3; }
      } else {
        const float x = __ldcs(src + v);
        if (beats(x, v, best, arg)) { best = x; arg = v; }
      }
    }
  }
  for (int off = 1; off < L; off <<= 1) {
    const float w = __shfl_xor_sync(kFull, best, off);
    const int j = __shfl_xor_sync(kFull, arg, off);
    if (beats(w, j, best, arg)) { best = w; arg = j; }
  }
  return arg;
}

// The confusion-matrix cell (i, j) = (target, pred) of a sample, from the
// index b = target * C + pred in int32 arithmetic that wraps as XLA's does:
// b < 0 counts in bin 0 and b >= C*C nowhere (false), as jnp.bincount; with
// an ignore_index, a sample whose target is it counts nowhere and pred is
// first clamped to [0, C-1].
template <bool IGNORE>
__device__ __forceinline__ bool row_bin(int pred, int t, int C, int ignore_index, int& i, int& j) {
  if (IGNORE) {
    if (t == ignore_index) return false;
    pred = pred < 0 ? 0 : (pred > C - 1 ? C - 1 : pred);
  }
  int b = static_cast<int>(static_cast<unsigned>(t) * static_cast<unsigned>(C) + static_cast<unsigned>(pred));
  if (b < 0) b = 0;
  if (b >= C * C) return false;
  i = b / C;
  j = b - i * C;
  return true;
}

struct Shape {
  long long n;  // rows
  int C;        // classes
  int llpr;     // log2 of the lanes per row (scores mode)
  int ignore_index;
  long long rows_per_block;
};

// K2, and K2s at one cell: `cells`, where given, masks the rows of cell -1 out.
template <bool SCORES, int VEC, bool IGNORE, bool SMEM, typename Pred, typename Tgt>
__global__ void __launch_bounds__(kThreads) stat_counts_kernel(
    const float* __restrict__ scores, const Pred* __restrict__ labels, const Tgt* __restrict__ target,
    const int* __restrict__ cells, Shape s, int* __restrict__ out) {
  extern __shared__ int s_part[];  // (4, C): tp, fp, tn without the total, fn
  __shared__ int s_total[kThreads / 32];
  const int C = s.C;
  int* part = SMEM ? s_part : out;
  if (SMEM) {
    for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) s_part[i] = 0;
    __syncthreads();
  }
  const int L = SCORES ? 1 << s.llpr : 1;
  const int sub = threadIdx.x & (L - 1);  // this lane's place in its row's group
  const int rows_per_step = blockDim.x >> (SCORES ? s.llpr : 0);
  const long long r_begin = static_cast<long long>(blockIdx.x) * s.rows_per_block;
  const long long r_end = min(s.n, r_begin + s.rows_per_block);
  int total = 0;

  // every thread runs the same steps, so the shuffles see the whole warp
  for (long long base = r_begin; base < r_end; base += static_cast<long long>(rows_per_step) * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + static_cast<long long>(u) * rows_per_step + (threadIdx.x >> (SCORES ? s.llpr : 0));
      const bool live = row < r_end;
      const int pred = row_pred<SCORES, VEC>(scores, labels, row, live, C, L, sub);
      if (!live || sub != 0) continue;
      if (cells != nullptr && cells[row] < 0) continue;
      int i, j;
      if (!row_bin<IGNORE>(pred, static_cast<int>(target[row]), C, s.ignore_index, i, j)) continue;
      // each sample adds to tp, fp, fn and tn directly (see the note above)
      ++total;
      if (i == j) {
        atomicAdd(&part[i], 1);
        atomicAdd(&part[2 * C + i], -1);
      } else {
        atomicAdd(&part[C + j], 1);
        atomicAdd(&part[3 * C + i], 1);
        atomicAdd(&part[2 * C + i], -1);
        atomicAdd(&part[2 * C + j], -1);
      }
    }
  }

  // the block's total, which every tn[c] gets
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
  if ((threadIdx.x & 31) == 0) s_total[threadIdx.x >> 5] = total;
  __syncthreads();
  int block_total = 0;
  for (int w = 0; w < kWarps; ++w) block_total += s_total[w];
  if (block_total == 0 && !SMEM) return;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (SMEM) {
      const int tp = s_part[c], fp = s_part[C + c], tn = s_part[2 * C + c] + block_total, fn = s_part[3 * C + c];
      if (tp) atomicAdd(&out[c], tp);
      if (fp) atomicAdd(&out[C + c], fp);
      if (tn) atomicAdd(&out[2 * C + c], tn);
      if (fn) atomicAdd(&out[3 * C + c], fn);
    } else {
      atomicAdd(&out[2 * C + c], block_total);
    }
  }
}

template <bool SCORES, int VEC, bool IGNORE, bool SMEM, typename Pred, typename Tgt>
cudaError_t launch(const float* scores, const Pred* labels, const Tgt* target, const int* cells, Shape s, int* out,
                   cudaStream_t stream) {
  auto kernel = stat_counts_kernel<SCORES, VEC, IGNORE, SMEM, Pred, Tgt>;
  const size_t smem = SMEM ? 4 * static_cast<size_t>(s.C) * sizeof(int) : 0;
  static LaunchCache cache[kMaxDevices] = {};
  int sms = 0;
  const cudaError_t err = hist_launch::prepare(kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  // about two blocks per SM, each with at least one full step of rows
  const long long rows_per_step = kThreads >> (SCORES ? s.llpr : 0);
  const long long steps = (s.n + rows_per_step - 1) / rows_per_step;
  const long long blocks = std::max(1LL, std::min(2LL * sms, steps));
  s.rows_per_block = (s.n + blocks - 1) / blocks;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(scores, labels, target, cells, s, out);
  return cudaGetLastError();
}

// ------------------------------------------------------------ segmented mode

struct SegShape {
  long long n;  // rows
  int C;        // classes
  int llpr;     // log2 of the lanes per row (scores mode)
  int ignore_index;
  int num_cells;
  long long rows_per_block;  // the cell-counter route
};

// Over more than one cell: every block holds the counters of all cells, two
// 16-bit counters a word (a block counts at most 65535 rows); its rows in order, as K2.
__device__ __forceinline__ void bump(unsigned* pk, int t) { atomicAdd(&pk[t >> 1], (t & 1) ? 0x10000u : 1u); }

template <bool SCORES, int VEC, bool IGNORE, typename Pred, typename Tgt>
__global__ void __launch_bounds__(kThreads) stat_counts_cells_kernel(
    const float* __restrict__ scores, const Pred* __restrict__ labels, const Tgt* __restrict__ target,
    const int* __restrict__ cells, SegShape s, int* __restrict__ acc) {
  extern __shared__ unsigned s_pk[];  // (num_cells, 3, C) counters d, r, q, packed in pairs
  const int C = s.C;
  const int counters = s.num_cells * 3 * C;
  const int words = (counters + 1) >> 1;
  for (int k = threadIdx.x; k < words; k += blockDim.x) s_pk[k] = 0;
  __syncthreads();
  const int lg = SCORES ? s.llpr : 0;
  const int L = 1 << lg;
  const int sub = threadIdx.x & (L - 1);
  const int rows_per_step = blockDim.x >> lg;
  const long long r_begin = static_cast<long long>(blockIdx.x) * s.rows_per_block;
  const long long r_end = min(s.n, r_begin + s.rows_per_block);
  for (long long base = r_begin; base < r_end; base += static_cast<long long>(rows_per_step) * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + static_cast<long long>(u) * rows_per_step + (threadIdx.x >> lg);
      const bool live = row < r_end;
      const int pred = row_pred<SCORES, VEC>(scores, labels, row, live, C, L, sub);
      if (!live || sub != 0) continue;
      const int cell = cells[row];
      if (cell < 0) continue;
      int i, j;
      if (!row_bin<IGNORE>(pred, static_cast<int>(target[row]), C, s.ignore_index, i, j)) continue;
      const int at = cell * 3 * C;
      bump(s_pk, at + C + i);
      bump(s_pk, at + 2 * C + j);
      if (i == j) bump(s_pk, at + i);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < words; k += blockDim.x) {
    const unsigned v = s_pk[k];
    if (v & 0xffffu) atomicAdd(&acc[2 * k], static_cast<int>(v & 0xffffu));
    if (v >> 16) atomicAdd(&acc[2 * k + 1], static_cast<int>(v >> 16));
  }
}

// The cell counters' second launch: a warp a cell derives its four rows
// from the summed counters d, r, q and the cell's total, the sum of r, in
// unsigned arithmetic that wraps as int32 sums do.
__global__ void __launch_bounds__(kThreads) stat_counts_derive_kernel(const int* __restrict__ acc, int num_cells, int C,
                                                                      int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long cell = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5; cell < num_cells; cell += warps) {
    const unsigned* d = reinterpret_cast<const unsigned*>(acc) + cell * 3 * C;
    const unsigned* r = d + C;
    const unsigned* q = r + C;
    unsigned total = 0;
    for (int c = lane; c < C; c += 32) total += r[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
    int* o = out + cell * 4 * C;
    for (int c = lane; c < C; c += 32) {
      o[c] = static_cast<int>(d[c]);
      o[C + c] = static_cast<int>(q[c] - d[c]);
      o[2 * C + c] = static_cast<int>(total - r[c] - q[c] + d[c]);
      o[3 * C + c] = static_cast<int>(r[c] - d[c]);
    }
  }
}

// The global route: an atomic per partial into the row's cell, its +1 into the cell's total.
template <bool SCORES, int VEC, bool IGNORE, typename Pred, typename Tgt>
__global__ void __launch_bounds__(kThreads) stat_counts_segmented_kernel(
    const float* __restrict__ scores, const Pred* __restrict__ labels, const Tgt* __restrict__ target,
    const int* __restrict__ cells, SegShape s, int* __restrict__ totals, int* __restrict__ out) {
  const int C = s.C;
  const int lg = SCORES ? s.llpr : 0;
  const int L = 1 << lg;
  const int sub = threadIdx.x & (L - 1);
  const long long groups = (static_cast<long long>(gridDim.x) * blockDim.x) >> lg;
  // the loop's trip count is the block's, so the shuffles see the whole warp
  for (long long base = (static_cast<long long>(blockIdx.x) * blockDim.x) >> lg; base < s.n; base += groups) {
    const long long row = base + (threadIdx.x >> lg);
    const bool live = row < s.n;
    const int pred = row_pred<SCORES, VEC>(scores, labels, row, live, C, L, sub);
    if (!live || sub != 0) continue;
    const int cell = cells[row];
    if (cell < 0) continue;  // a spilled row
    int i, j;
    if (!row_bin<IGNORE>(pred, static_cast<int>(target[row]), C, s.ignore_index, i, j)) continue;
    int* part = out + static_cast<long long>(cell) * 4 * C;
    atomicAdd(&totals[cell], 1);
    if (i == j) {
      atomicAdd(&part[i], 1);
      atomicAdd(&part[2 * C + i], -1);
    } else {
      atomicAdd(&part[C + j], 1);
      atomicAdd(&part[3 * C + i], 1);
      atomicAdd(&part[2 * C + i], -1);
      atomicAdd(&part[2 * C + j], -1);
    }
  }
}

// tn[cell, c] += the cell's total, which every tn of the cell gets
__global__ void __launch_bounds__(kThreads) add_cell_totals_kernel(const int* __restrict__ totals, int num_cells, int C,
                                                                   int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(num_cells) * C) return;
  const long long cell = i / C;
  const int total = totals[cell];
  if (total == 0) return;
  int* tn = out + cell * 4 * C + 2 * C + (i - cell * C);
  *tn = static_cast<int>(static_cast<unsigned>(*tn) + static_cast<unsigned>(total));
}

// The routes of K2s (the wrapper picks one; see stat_counts_segmented below).
enum Route { kOneCell = 0, kCellCounters = 1, kGlobal = 2 };

struct SegArgs {
  const int* cells;
  int route;
  int* scratch;
  int* out;
  cudaStream_t stream;
};

// Blocks for a grid over n rows, at most `per_sm` a SM, each with a full step of rows.
long long row_blocks(long long n, long long rows_per_step, int sms, int per_sm) {
  return std::max(1LL, std::min(static_cast<long long>(per_sm) * sms, (n + rows_per_step - 1) / rows_per_step));
}

template <bool SCORES, int VEC, bool IGNORE, typename Pred, typename Tgt>
cudaError_t launch_segmented(const float* scores, const Pred* labels, const Tgt* target, SegShape s, SegArgs a) {
  const long long rows_per_step = kThreads >> (SCORES ? s.llpr : 0);
  int sms = 0;
  cudaError_t err;
  if (a.route == kOneCell) {
    const Shape one{s.n, s.C, s.llpr, s.ignore_index, 0};
    return 4 * static_cast<size_t>(s.C) * sizeof(int) <= kDefaultSmem
               ? launch<SCORES, VEC, IGNORE, true>(scores, labels, target, a.cells, one, a.out, a.stream)
               : launch<SCORES, VEC, IGNORE, false>(scores, labels, target, a.cells, one, a.out, a.stream);
  }
  if (a.route == kCellCounters) {
    auto kernel = stat_counts_cells_kernel<SCORES, VEC, IGNORE, Pred, Tgt>;
    static LaunchCache cache[kMaxDevices] = {};
    const size_t smem = (static_cast<size_t>(s.num_cells) * 3 * s.C + 1) / 2 * sizeof(unsigned);
    if (smem > kCellSmemMax) return cudaErrorInvalidValue;
    if ((err = hist_launch::prepare(kernel, smem, cache, &sms)) != cudaSuccess) return err;
    const int per_sm = static_cast<int>(std::max<size_t>(1, std::min<size_t>(4, kSmSmem / (smem + 1024))));
    long long blocks = row_blocks(s.n, rows_per_step * kUnroll, sms, per_sm);
    blocks = std::max(blocks, (s.n + kMaxBlockRows - 1) / kMaxBlockRows);  // a 16-bit counter holds a block's rows
    s.rows_per_block = (s.n + blocks - 1) / blocks;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(scores, labels, target, a.cells, s, a.scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long warps_needed = s.num_cells;
    const long long dblocks = std::max(1LL, std::min(8LL * sms, (warps_needed * 32 + kThreads - 1) / kThreads));
    stat_counts_derive_kernel<<<static_cast<unsigned>(dblocks), kThreads, 0, a.stream>>>(a.scratch, s.num_cells, s.C, a.out);
    return cudaGetLastError();
  }
  auto kernel = stat_counts_segmented_kernel<SCORES, VEC, IGNORE, Pred, Tgt>;
  static LaunchCache cache[kMaxDevices] = {};
  if ((err = hist_launch::prepare(kernel, 0, cache, &sms)) != cudaSuccess) return err;
  const long long blocks = row_blocks(s.n, rows_per_step, sms, 4);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(scores, labels, target, a.cells, s, a.scratch, a.out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long elems = static_cast<long long>(s.num_cells) * s.C;
  add_cell_totals_kernel<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0, a.stream>>>(
      a.scratch, s.num_cells, s.C, a.out);
  return cudaGetLastError();
}

// One entry for both modes: the segmented one when seg != nullptr.
template <bool SCORES, int VEC, typename Pred, typename Tgt>
cudaError_t dispatch(const float* scores, const Pred* labels, const Tgt* target, int has_ignore, Shape s, int* out,
                     const SegShape* seg, const SegArgs* a, cudaStream_t stream) {
  if (seg != nullptr) {
    return has_ignore ? launch_segmented<SCORES, VEC, true>(scores, labels, target, *seg, *a)
                      : launch_segmented<SCORES, VEC, false>(scores, labels, target, *seg, *a);
  }
  const bool smem = 4 * static_cast<size_t>(s.C) * sizeof(int) <= kDefaultSmem;
  if (has_ignore) {
    return smem ? launch<SCORES, VEC, true, true>(scores, labels, target, nullptr, s, out, stream)
                : launch<SCORES, VEC, true, false>(scores, labels, target, nullptr, s, out, stream);
  }
  return smem ? launch<SCORES, VEC, false, true>(scores, labels, target, nullptr, s, out, stream)
              : launch<SCORES, VEC, false, false>(scores, labels, target, nullptr, s, out, stream);
}

template <typename Tgt>
cudaError_t dispatch_preds(const void* preds, int preds_mode, const Tgt* target, int has_ignore, Shape s, int* out,
                           const SegShape* seg, const SegArgs* a, cudaStream_t stream) {
  switch (preds_mode) {
    case 0:  // float32 scores, float4 rows
      return dispatch<true, 4, int>(static_cast<const float*>(preds), nullptr, target, has_ignore, s, out, seg, a, stream);
    case 1:  // float32 scores, scalar loads
      return dispatch<true, 1, int>(static_cast<const float*>(preds), nullptr, target, has_ignore, s, out, seg, a, stream);
    case 2:  // int32 labels
      return dispatch<false, 1>(nullptr, static_cast<const int*>(preds), target, has_ignore, s, out, seg, a, stream);
    default:  // int64 labels
      return dispatch<false, 1>(nullptr, static_cast<const long long*>(preds), target, has_ignore, s, out, seg, a, stream);
  }
}

}  // namespace

// preds: (n, c) float32 scores, contiguous (preds_mode 0: rows may be read as
// float4, c % 4 == 0 and 16-byte aligned; 1: scalar loads), or (n,) labels
// (2: int32, 3: int64); target: (n,) int32 (target64 == 0) or int64;
// out: (4, c) int32, zeroed. llpr: log2 of the lanes per row for scores.
extern "C" int stat_counts(const void* preds, int preds_mode, const void* target, int target64, long long n, int c,
                           int llpr, int has_ignore, int ignore_index, void* out, void* stream) {
  if (n == 0) return 0;
  const Shape s{n, c, llpr, ignore_index, 0};
  auto* out_ = static_cast<int*>(out);
  auto stream_ = static_cast<cudaStream_t>(stream);
  if (target64)
    return dispatch_preds(preds, preds_mode, static_cast<const long long*>(target), has_ignore, s, out_, nullptr, nullptr,
                          stream_);
  return dispatch_preds(preds, preds_mode, static_cast<const int*>(target), has_ignore, s, out_, nullptr, nullptr, stream_);
}

// stat_counts's arguments, and cells: (n,) int32, each row's cohort cell or
// -1 (dropped); route and what it takes: 0, one cell: out (1, 4, c) zeroed,
// no scratch; 1, cell counters: out (num_cells, 4, c) uninitialised,
// scratch (num_cells * 3 * c) int32 zeroed, ceil(num_cells * 3 * c / 2) * 4
// bytes <= 227 KB; 2, global: out zeroed, scratch (num_cells,) int32 zeroed.
extern "C" int stat_counts_segmented(const void* preds, int preds_mode, const void* target, int target64,
                                     const void* cells, long long n, int c, int num_cells, int llpr, int has_ignore,
                                     int ignore_index, int route, void* scratch, void* out, void* stream) {
  if (n == 0 || num_cells == 0) return 0;
  const SegShape seg{n, c, llpr, ignore_index, num_cells, 0};
  const SegArgs a{static_cast<const int*>(cells), route, static_cast<int*>(scratch), static_cast<int*>(out),
                  static_cast<cudaStream_t>(stream)};
  const Shape unused{n, c, llpr, ignore_index, 0};
  if (target64)
    return dispatch_preds(preds, preds_mode, static_cast<const long long*>(target), has_ignore, unused, nullptr, &seg, &a,
                          a.stream);
  return dispatch_preds(preds, preds_mode, static_cast<const int*>(target), has_ignore, unused, nullptr, &seg, &a, a.stream);
}
