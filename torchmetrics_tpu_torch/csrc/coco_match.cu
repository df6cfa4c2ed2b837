// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// coco_match: COCO's greedy matching of score-ordered detections to ground
// truths, for every (image, area range, IoU threshold) at once, by hand
// for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/detection/map.py::_match_one_image,
//   a lax.scan over the detections (vmapped over images) that the JAX
//   package's docstring calls the O(images * D * G * T * A) hot loop. It is
//   not a Pallas kernel (the JAX package has none): the scan ported step by
//   step is about 15 launches a detection, some 1,500 a compute at COCO's
//   100 detections an image.
//
// Computes, for image n, area range a and threshold t, with every ground
// truth g unmatched at the start, for d = 0..D-1 in order:
//   ok[g]    = det_valid[d] & gt_valid[g] & det_label[d] == gt_label[g]
//   stage 1: v1[g] = ok & !ig[a][g] & !matched[g]                ? iou[d][g] : -1
//   stage 2: v2[g] = ok &  ig[a][g] & (crowd[g] | !matched[g])   ? iou[d][g] : -1
//   best_s   = the last index of the largest v_s (a NaN counts as the
//              largest, and the last NaN wins), max_s its value (NaN if any)
//   ok_s     = max_s >= thr[t]  (false for a NaN)
//   matched  = ok_1 | ok_2, m = ok_1 ? best_1 : best_2
//   det_matched[n][a][t][d] = matched, det_ignored[...] = matched & ig[a][m],
//   and g = m joins the matched set when matched.
// Only compares and selects: the result is the plain PyTorch loop's
// (ops/coco_match.py) and JAX's bit for bit. thr is min(t, 1 - 1e-10) in
// float32, taken by the wrapper.
//
// Bound on the card: the chain. Each detection's choice reads the matched
// set its predecessors left, so a warp walks its D detections one after
// the other, and each step is a pass over G / 32 lanes' values and two
// five-round shuffle reductions. The bytes (the (N, D, G) IoU read once,
// the outputs written once) and the compares (a few per (n, a, t, d, g))
// take far less at COCO's shapes when the card is full.
//
// Design (simple and right): a block per (image, area range), a warp per
// threshold (up to kWarps a block; more thresholds take more blocks along
// y). The block stages the image's IoU rows, its ground truths' labels
// and flags and its detections' labels in shared memory when they fit in
// kStageMax bytes (26.6 KB of IoU at COCO's 104 x 64), else its warps read
// them from device memory (through L1). Lane l holds ground truths
// l, l + 32, ...; the matched set is one bit per ground truth, in a
// register of its lane while G <= 1024, else in a zeroed device scratch
// (one word per lane per 32 chunks of a warp, coalesced).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 16;                // thresholds a block
constexpr size_t kStageMax = 48 * 1024;   // bytes a block stages (no opt-in needed)
constexpr int kRegChunks = 32;            // chunks of 32 ground truths a register holds

// (value, index) pairs: is b preferred to a? NaN is the largest value and
// the later index wins a tie, as jnp.argmax over the reversed row gives.
__device__ __forceinline__ bool prefer(float bv, int bi, float av, int ai) {
  const bool bn = isnan(bv), an = isnan(av);
  if (bn != an) return bn;
  if (bn) return bi > ai;
  return bv > av || (bv == av && bi > ai);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (prefer(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// flags of a ground truth: bit 0 valid, bit 1 ignored in this area range, bit 2 crowd
constexpr uint8_t kValid = 1, kIgnored = 2, kCrowd = 4;

template <bool kStaged, bool kRegBits>
__global__ void coco_match_kernel(const float* __restrict__ iou, const int* __restrict__ det_labels,
                                  const uint8_t* __restrict__ det_valid, const int* __restrict__ gt_labels,
                                  const uint8_t* __restrict__ gt_valid, const uint8_t* __restrict__ gt_crowd,
                                  const uint8_t* __restrict__ gt_ig, const float* __restrict__ thr,
                                  uint8_t* __restrict__ det_matched, uint8_t* __restrict__ det_ignored,
                                  uint32_t* __restrict__ scratch, int D, int G, int A, int T, int scratch_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long na = blockIdx.x;  // n * A + a
  const long long n = na / A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y * kWarps + warp;

  const float* rows = iou + n * D * static_cast<long long>(G);
  const int* dl = det_labels + n * D;
  const uint8_t* dv = det_valid + n * D;
  const int* gl = gt_labels + n * G;
  const uint8_t* gflags = nullptr;
  if (kStaged) {
    float* s_rows = reinterpret_cast<float*>(smem);
    int* s_gl = reinterpret_cast<int*>(s_rows + static_cast<size_t>(D) * G);
    int* s_dl = s_gl + G;
    uint8_t* s_gf = reinterpret_cast<uint8_t*>(s_dl + D);
    uint8_t* s_dv = s_gf + G;
    for (long long k = threadIdx.x; k < static_cast<long long>(D) * G; k += blockDim.x) s_rows[k] = rows[k];
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      s_gl[g] = gl[g];
      s_gf[g] = (gt_valid[n * G + g] ? kValid : 0) | (gt_ig[na * G + g] ? kIgnored : 0) | (gt_crowd[n * G + g] ? kCrowd : 0);
    }
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      s_dl[d] = dl[d];
      s_dv[d] = dv[d];
    }
    __syncthreads();
    rows = s_rows;
    gl = s_gl;
    dl = s_dl;
    dv = s_dv;
    gflags = s_gf;
  }
  if (t >= T) return;  // after the block's only barrier

  auto flags_of = [&](int g) -> uint8_t {
    if (kStaged) return gflags[g];
    return (gt_valid[n * G + g] ? kValid : 0) | (gt_ig[na * G + g] ? kIgnored : 0) | (gt_crowd[n * G + g] ? kCrowd : 0);
  };
  const float bar = thr[t];
  uint32_t bits = 0;  // kRegBits: bit c is ground truth 32 c + lane
  uint32_t* words = kRegBits ? nullptr : scratch + ((na * T + t) * scratch_words) * 32 + lane;
  auto is_matched = [&](int c) -> bool {
    if (kRegBits) return (bits >> c) & 1u;
    return (words[(c >> 5) * 32] >> (c & 31)) & 1u;
  };
  uint8_t* out_m = det_matched + (na * T + t) * D;
  uint8_t* out_i = det_ignored + (na * T + t) * D;

  for (int d = 0; d < D; ++d) {
    const bool dok = dv[d] != 0;
    const int label = dl[d];
    const float* row = rows + static_cast<long long>(d) * G;
    float v1 = -INFINITY, v2 = -INFINITY;
    int i1 = -1, i2 = -1;
    for (int g = lane, c = 0; g < G; g += 32, ++c) {
      const uint8_t f = flags_of(g);
      const bool ok = dok && (f & kValid) && gl[g] == label;
      const bool ig = f & kIgnored;
      const bool m = is_matched(c);
      const float x = row[g];
      const float c1 = (ok && !ig && !m) ? x : -1.0f;
      const float c2 = (ok && ig && ((f & kCrowd) || !m)) ? x : -1.0f;
      if (prefer(c1, g, v1, i1)) {
        v1 = c1;
        i1 = g;
      }
      if (prefer(c2, g, v2, i2)) {
        v2 = c2;
        i2 = g;
      }
    }
    warp_best(v1, i1);
    warp_best(v2, i2);
    const bool ok1 = v1 >= bar, ok2 = v2 >= bar;  // false for a NaN
    const bool matched = ok1 || ok2;
    const int m = ok1 ? i1 : i2;
    if (matched && (m & 31) == lane) {
      const int c = m >> 5;
      if (kRegBits) {
        bits |= 1u << c;
      } else {
        words[(c >> 5) * 32] |= 1u << (c & 31);
      }
    }
    if ((d & 31) == lane) {
      out_m[d] = matched;
      out_i[d] = matched && (flags_of(m) & kIgnored);
    }
  }
}

template <bool kStaged, bool kRegBits>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream, const float* iou, const int* det_labels,
                   const uint8_t* det_valid, const int* gt_labels, const uint8_t* gt_valid, const uint8_t* gt_crowd,
                   const uint8_t* gt_ig, const float* thr, uint8_t* det_matched, uint8_t* det_ignored,
                   uint32_t* scratch, int D, int G, int A, int T, int scratch_words) {
  coco_match_kernel<kStaged, kRegBits><<<grid, block, kStaged ? smem : 0, stream>>>(
      iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched, det_ignored, scratch, D, G, A,
      T, scratch_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory a block stages for (D, G), or 0 when they exceed
// kStageMax and the warps read device memory instead.
size_t coco_match_stage_bytes(int D, int G) {
  const size_t bytes = static_cast<size_t>(D) * G * 4 + static_cast<size_t>(G) * 5 + static_cast<size_t>(D) * 5;
  return bytes <= kStageMax ? bytes : 0;
}

// Words of scratch a warp needs for its matched set (0: it fits a register).
int coco_match_scratch_words(int G) {
  const int chunks = (G + 31) / 32;
  return chunks <= kRegChunks ? 0 : (chunks + 31) / 32;
}

// iou (N, D, G) float32; det_labels (N, D) int32; det_valid (N, D) bool;
// gt_labels (N, G) int32; gt_valid, gt_crowd (N, G) bool; gt_ig (N, A, G)
// bool; thr (T,) float32 (already min(t, 1 - 1e-10)); det_matched and
// det_ignored (N, A, T, D) bool, written whole; scratch: N * A * T *
// coco_match_scratch_words(G) * 32 zeroed uint32 words, or null when that is 0.
int coco_match(const float* iou, const int* det_labels, const uint8_t* det_valid, const int* gt_labels,
               const uint8_t* gt_valid, const uint8_t* gt_crowd, const uint8_t* gt_ig, const float* thr,
               uint8_t* det_matched, uint8_t* det_ignored, uint32_t* scratch, long long N, int D, int G, int A, int T,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0 || D == 0 || A == 0 || T == 0) return 0;
  const int warps = T < kWarps ? T : kWarps;
  const dim3 grid(static_cast<unsigned>(N * A), static_cast<unsigned>((T + kWarps - 1) / kWarps));
  const dim3 block(32 * warps);
  const size_t smem = coco_match_stage_bytes(D, G);
  const int words = coco_match_scratch_words(G);
  if (smem > 0) {
    if (words == 0)
      return launch<true, true>(grid, block, smem, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd,
                                gt_ig, thr, det_matched, det_ignored, scratch, D, G, A, T, words);
    return launch<true, false>(grid, block, smem, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd,
                               gt_ig, thr, det_matched, det_ignored, scratch, D, G, A, T, words);
  }
  if (words == 0)
    return launch<false, true>(grid, block, 0, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig,
                               thr, det_matched, det_ignored, scratch, D, G, A, T, words);
  return launch<false, false>(grid, block, 0, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig,
                              thr, det_matched, det_ignored, scratch, D, G, A, T, words);
}

}  // extern "C"
