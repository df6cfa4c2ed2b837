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
// Bound on the card: the work that depends on the data. A detection can
// only take a valid ground truth of its own label: at COCO's 80 classes and
// 7.4 annotations an image that is 0-3 candidates a step, out of the 64
// padded columns of an IoU row, and most detections have none. So a step
// is a few word operations on bitmasks and a compare for each candidate;
// the least bytes are the labels, the flags, the candidates' IoU sectors
// and the outputs (the outputs the most: one byte a detection, area range
// and threshold).
//
// Design: a thread per (image, area range, threshold), the pairs in
// (n, a, t) order, so a block of up to 256 threads covers a run of whole
// and partial images and each thread walks its D detections alone. In a
// prologue the block's warps build, by ballots, each image's bitmasks of
// G bits in shared memory: crowd, ig[a] for each area range, and ok[d] for
// each detection; beside them they stage the IoUs of the first kStage
// candidates of each (detection, mask word), all loaded at once, off the
// walk's chain. A step is then, word by word,
//   c1 = ok[d] & ~ig[a] & ~matched,  c2 = ok[d] & ig[a] & (crowd | ~matched)
// and a walk over the set bits of ok[d] in ascending order (the same for
// every lane of an image), each candidate's IoU from the
// stage (a further one through L1, one address for the lanes of an image)
// kept by the NaN-aware `prefer` rule. Every other column holds -1.0, so
// the dense row's answer is the better of the best candidate and a
// "filler" of value -1.0 at the highest index in [0, G) outside c_s, where
// there is one. Only a bar at or below -1.0 can take the filler, so only
// such a thread looks for it, and a detection without candidates under a
// higher bar matches nothing: its step is skipped. The matched set is W
// words in registers for G <= 128 (W = 1..4, one instantiation each); past
// that, or when a block's masks, stage and output bits overflow 48 KB of
// shared memory at 32 threads, one instantiation keeps masks, matched sets
// and output bits in a scratch the wrapper allocates (the kernel
// initialises it) and stages nothing. Outputs: each lane keeps a bit a
// step and a word every 32 steps, and at the end the warp writes its 32
// rows, one run of bytes, 8 (or 4, or 1) a lane a store: whole sectors,
// not a byte a row a step. At most 40 registers a thread (a few bytes
// spill), so six blocks share an SM and COCO's launch runs in one wave.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 256;              // threads a block, halved while its shared memory overflows kSmemMax
constexpr int kBlocksPerSm = 6;          // blocks of kBlock threads an SM holds (the register cap)
constexpr int kMinBlock = 32;
constexpr int kScratchBlock = 128;       // threads a block of the scratch instantiation
constexpr int kRegWords = 4;             // the matched set in registers up to 128 ground truths
constexpr size_t kSmemMax = 48 * 1024;   // bytes of masks, stage and output bits a block keeps (no opt-in)
constexpr int kStage = 2;                // candidates' IoUs a (detection, mask word) stages in shared memory

// (value, index) pairs: is b preferred to a? NaN is the largest value and
// the later index wins a tie, as jnp.argmax over the reversed row gives.
// -0.0 == +0.0, so they tie and the later index wins.
__device__ __forceinline__ bool prefer(float bv, int bi, float av, int ai) {
  const bool bn = isnan(bv), an = isnan(av);
  if (bn != an) return bn;
  if (bn) return bi > ai;
  return bv > av || (bv == av && bi > ai);
}

struct Plan {
  int words;              // 32-bit words of a G-bit mask
  int regs;               // the instantiation: words in registers, or 0 (scratch)
  int block;              // threads a block
  long long grid;         // blocks
  int images;             // most images a block covers
  long long stride;       // words an image: the masks crowd, ig[A], ok[D], then (registers) the staged IoUs
  size_t smem;            // bytes of shared memory a block (0 for the scratch instantiation)
  long long mask_words;   // scratch words of masks (the scratch instantiation)
  long long scratch_words;  // masks, then each thread's matched set, then its output bits
};

Plan make_plan(long long N, int D, int G, int A, int T) {
  Plan p{};
  const long long at = static_cast<long long>(A) * T;
  p.words = (G + 31) / 32;
  p.stride = static_cast<long long>(1 + A + D + D * kStage) * p.words;  // the register instantiations
  auto images = [&](int block) {
    const long long k = (block - 1) / at + 2;  // a run of `block` pairs touches at most this many images
    return static_cast<int>(k < N ? k : N);
  };
  auto grid = [&](int block) { return (N * at + block - 1) / block; };
  const long long out_words = 2LL * ((D + 31) / 32);  // a thread's det_matched and det_ignored bits
  if (p.words <= kRegWords) {
    for (int b = kBlock; b >= kMinBlock; b /= 2) {
      const size_t bytes = (static_cast<size_t>(images(b)) * p.stride + out_words * b) * 4;
      if (bytes <= kSmemMax) {
        p.regs = p.words;
        p.block = b;
        p.images = images(b);
        p.grid = grid(b);
        p.smem = bytes;
        return p;
      }
    }
  }
  p.regs = 0;
  p.stride = static_cast<long long>(1 + A + D) * p.words;  // nothing staged
  p.block = kScratchBlock;
  p.images = images(kScratchBlock);
  p.grid = grid(kScratchBlock);
  p.mask_words = p.grid * p.images * p.stride;
  p.scratch_words = p.mask_words + (p.words + out_words) * p.grid * p.block;
  return p;
}

// W > 0: the matched set in W registers, the masks, stage and output bits
// in shared memory; W == 0: any G, all of them in the scratch, no stage. At most 40 registers, so that six
// blocks of 256 threads share an SM: COCO val2017's 782 blocks run in one
// wave (a few bytes spill).
template <int W>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm) coco_match_kernel(
    const float* __restrict__ iou, const int* __restrict__ det_labels, const uint8_t* __restrict__ det_valid,
    const int* __restrict__ gt_labels, const uint8_t* __restrict__ gt_valid, const uint8_t* __restrict__ gt_crowd,
    const uint8_t* __restrict__ gt_ig, const float* __restrict__ thr, uint8_t* __restrict__ det_matched,
    uint8_t* __restrict__ det_ignored, uint32_t* scratch, long long N, int D, int G, int A, int T, int images,
    long long stride, long long mask_words) {
  extern __shared__ uint32_t smem[];
  const int nw = W > 0 ? W : (G + 31) >> 5;
  const long long at = static_cast<long long>(A) * T;
  const long long total = N * at;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long last = (first + blockDim.x < total ? first + blockDim.x : total) - 1;
  const long long img0 = first / at;
  const int n_img = static_cast<int>(last / at - img0) + 1;
  uint32_t* masks;
  if constexpr (W > 0) {
    masks = smem;
  } else {
    masks = scratch + static_cast<long long>(blockIdx.x) * images * stride;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

  // Prologue: the block's images' masks, a warp per (image, mask word, 32 detections).
  const int dchunks = (D + 31) >> 5;
  const int items = n_img * nw * dchunks;
  for (int item = warp; item < items; item += warps) {
    const int i = item / (nw * dchunks), rest = item - i * (nw * dchunks);
    const int w = rest / dchunks, dc = rest - w * dchunks;
    const long long n = img0 + i;
    const int g = w * 32 + lane, d = dc * 32 + lane;
    const bool gv = g < G && gt_valid[n * G + g];
    const int gl = g < G ? gt_labels[n * G + g] : 0;
    const int dl = d < D ? det_labels[n * D + d] : 0;
    const int dv = d < D && det_valid[n * D + d];
    uint32_t* m = masks + i * stride;
    if (dc == 0) {
      const uint32_t crowd = __ballot_sync(0xffffffffu, g < G && gt_crowd[n * G + g]);
      if (lane == 0) m[w] = crowd;
      for (int a = 0; a < A; ++a) {
        const uint32_t ig = __ballot_sync(0xffffffffu, g < G && gt_ig[(n * A + a) * G + g]);
        if (lane == 0) m[(1 + a) * nw + w] = ig;
      }
    }
    const int dn = D - dc * 32 < 32 ? D - dc * 32 : 32;
    uint32_t mine = 0;
    for (int j = 0; j < dn; ++j) {
      const int lj = __shfl_sync(0xffffffffu, dl, j), vj = __shfl_sync(0xffffffffu, dv, j);
      const uint32_t bits = __ballot_sync(0xffffffffu, vj && gv && gl == lj);
      if (lane == j) mine = bits;
    }
    if (lane < dn) {
      m[static_cast<long long>(1 + A + d) * nw + w] = mine;
      if constexpr (W > 0) {  // the first kStage candidates' IoUs, loaded here all at once
        const float* src = iou + (n * D + d) * static_cast<long long>(G) + w * 32;
        float* dst = reinterpret_cast<float*>(m + (1 + A + D) * nw) + (d * nw + w) * kStage;
        uint32_t u = mine;
#pragma unroll
        for (int c = 0; c < kStage; ++c) {
          dst[c] = u ? __ldg(src + __ffs(u) - 1) : 0.0f;
          u &= u - 1;
        }
      }
    }
  }
  __syncthreads();  // the block's only barrier

  // A lane past the last pair walks the last pair again and its row is not
  // written: every lane reaches the warp's output barrier.
  const long long p = first + threadIdx.x < total ? first + threadIdx.x : total - 1;
  const long long n = p / at;
  const int r = static_cast<int>(p - n * at), a = r / T, t = r - a * T;
  const uint32_t* img = masks + (n - img0) * stride;
  const uint32_t* crowd_m = img;
  const uint32_t* ig_m = img + (1 + a) * nw;
  const uint32_t* ok = img + (1 + A) * nw;
  const float* staged = reinterpret_cast<const float*>(img + (1 + A + D) * nw);  // W > 0
  const float* rows = iou + n * D * static_cast<long long>(G);
  const float bar = thr[t];
  // The -1.0 columns decide a step only under a bar at or below -1.0: above
  // it, -1.0 fails the bar and any candidate that passes beats it.
  const bool filler = bar <= -1.0f;  // false for a NaN
  const uint32_t top = (G & 31) ? (1u << (G & 31)) - 1u : 0xffffffffu;

  uint32_t cr_r[W > 0 ? W : 1], ig_r[W > 0 ? W : 1], mt_r[W > 0 ? W : 1];
  uint32_t* mt_s = nullptr;  // W == 0: word w of this thread's matched set at mt_s[w * mstride]
  const long long mstride = static_cast<long long>(gridDim.x) * blockDim.x;
  if constexpr (W > 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      cr_r[w] = crowd_m[w];
      ig_r[w] = ig_m[w];
      mt_r[w] = 0;
    }
  } else {
    mt_s = scratch + mask_words + first + threadIdx.x;
    for (int w = 0; w < nw; ++w) mt_s[w * mstride] = 0;
  }

  // this thread's output bits, word d / 32 of det_matched then of det_ignored,
  // at obuf[word * ostride + oid]
  const int nwd = (D + 31) >> 5;
  uint32_t* obuf;
  long long ostride, oid;
  if constexpr (W > 0) {
    obuf = smem + images * stride;
    ostride = blockDim.x;
    oid = threadIdx.x;
  } else {
    obuf = scratch + mask_words + nw * mstride;
    ostride = mstride;
    oid = first + threadIdx.x;
  }
  uint32_t out_m = 0, out_i = 0;  // bit d % 32: this step's det_matched / det_ignored
  for (int d = 0; d < D; ++d) {
    const uint32_t* okd = ok + static_cast<long long>(d) * nw;
    // A detection without a candidate (most of them: no valid ground truth
    // of its label) matches nothing unless a -1.0 column can: no step.
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < nw; ++w) any |= okd[w];
    bool matched = false, ignored = false;
    if (any || filler) {
      const float* row = rows + static_cast<long long>(d) * G;
      float v1 = -INFINITY, v2 = -INFINITY;
      int i1 = -1, i2 = -1, f1 = -1, f2 = -1;
#pragma unroll
      for (int w = 0; w < nw; ++w) {
        uint32_t ig, cr, mt;
        if constexpr (W > 0) {
          ig = ig_r[w];
          cr = cr_r[w];
          mt = mt_r[w];
        } else {
          ig = ig_m[w];
          cr = crowd_m[w];
          mt = mt_s[w * mstride];
        }
        const uint32_t k = okd[w];
        const uint32_t c1 = k & ~ig & ~mt, c2 = k & ig & (cr | ~mt);
        if (filler) {
          const uint32_t valid = w == nw - 1 ? top : 0xffffffffu;
          const uint32_t z1 = ~c1 & valid, z2 = ~c2 & valid;  // the columns that hold -1.0
          if (z1) f1 = w * 32 + 31 - __clz(z1);
          if (z2) f2 = w * 32 + 31 - __clz(z2);
        }
        int c = 0;
        for (uint32_t u = k; u; u &= u - 1, ++c) {
          const int b = __ffs(u) - 1, g = w * 32 + b;
          float x;
          if constexpr (W > 0) {
            x = c < kStage ? staged[(d * nw + w) * kStage + c] : __ldg(row + g);
          } else {
            x = __ldg(row + g);
          }
          // g exceeds every index kept so far, so `prefer(x, g, v, i)` is: x is
          // a NaN, or v is not and x >= v (a tie goes to the later g)
          const bool xn = isnan(x);
          const bool t1 = ((c1 >> b) & 1u) && (xn || (!isnan(v1) && x >= v1));
          const bool t2 = ((c2 >> b) & 1u) && (xn || (!isnan(v2) && x >= v2));
          v1 = t1 ? x : v1;
          i1 = t1 ? g : i1;
          v2 = t2 ? x : v2;
          i2 = t2 ? g : i2;
        }
      }
      if (f1 >= 0 && prefer(-1.0f, f1, v1, i1)) {
        v1 = -1.0f;
        i1 = f1;
      }
      if (f2 >= 0 && prefer(-1.0f, f2, v2, i2)) {
        v2 = -1.0f;
        i2 = f2;
      }
      const bool ok1 = v1 >= bar, ok2 = v2 >= bar;  // false for a NaN
      matched = ok1 || ok2;
      if (matched) {
        const int m = ok1 ? i1 : i2, mw = m >> 5;
        const uint32_t bit = 1u << (m & 31);
        if constexpr (W > 0) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (w == mw) {
              mt_r[w] |= bit;
              ignored = ig_r[w] & bit;
            }
          }
        } else {
          mt_s[mw * mstride] |= bit;
          ignored = ig_m[mw] & bit;
        }
      }
    }
    out_m |= static_cast<uint32_t>(matched) << (d & 31);
    out_i |= static_cast<uint32_t>(ignored) << (d & 31);
    if ((d & 31) == 31 || d == D - 1) {
      obuf[static_cast<long long>(d >> 5) * ostride + oid] = out_m;
      obuf[static_cast<long long>(nwd + (d >> 5)) * ostride + oid] = out_i;
      out_m = out_i = 0;
    }
  }

  // The warp's rows are one run of bytes: written whole, q bytes a lane a
  // store, bit col of row r expanded to a byte.
  __syncwarp();
  const long long warp_first = first + (threadIdx.x & ~31);
  const long long rows_left = total - warp_first;
  if (rows_left <= 0) return;
  const long long run = (rows_left < 32 ? rows_left : 32) * D;
  const long long oid0 = oid - lane;
  const int q = (D & 7) == 0 ? 8 : (D & 3) == 0 ? 4 : 1;
  for (int o = 0; o < 2; ++o) {
    uint8_t* dst = (o ? det_ignored : det_matched) + warp_first * D;
    const uint32_t* src = obuf + static_cast<long long>(o * nwd) * ostride + oid0;
    for (long long k = static_cast<long long>(lane) * q; k < run; k += 32 * q) {
      const int row = static_cast<int>(k / D), col = static_cast<int>(k - static_cast<long long>(row) * D);
      const uint32_t bits = src[static_cast<long long>(col >> 5) * ostride + row] >> (col & 31);
      if (q == 8) {
        const uint2 v = {((bits & 0xfu) * 0x00204081u) & 0x01010101u, (((bits >> 4) & 0xfu) * 0x00204081u) & 0x01010101u};
        *reinterpret_cast<uint2*>(dst + k) = v;
      } else if (q == 4) {
        *reinterpret_cast<uint32_t*>(dst + k) = ((bits & 0xfu) * 0x00204081u) & 0x01010101u;
      } else {
        dst[k] = bits & 1u;
      }
    }
  }
}

template <int W>
cudaError_t launch(const Plan& p, cudaStream_t stream, const float* iou, const int* det_labels,
                   const uint8_t* det_valid, const int* gt_labels, const uint8_t* gt_valid, const uint8_t* gt_crowd,
                   const uint8_t* gt_ig, const float* thr, uint8_t* det_matched, uint8_t* det_ignored,
                   uint32_t* scratch, long long N, int D, int G, int A, int T) {
  coco_match_kernel<W><<<static_cast<unsigned>(p.grid), p.block, p.smem, stream>>>(
      iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched, det_ignored, scratch, N, D,
      G, A, T, p.images, p.stride, p.mask_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Words of uint32 scratch the launch for (N, D, G, A, T) needs, into *words
// (0: the register instantiations need none). The kernel initialises it.
int coco_match_scratch_words(long long N, int D, int G, int A, int T, long long* words) {
  *words = (N == 0 || D == 0 || G == 0 || A == 0 || T == 0) ? 0 : make_plan(N, D, G, A, T).scratch_words;
  return 0;
}

// The instantiation the launch for (N, D, G, A, T) takes: 1-4, the words of
// its matched set in registers, or 0, the scratch one; -1 for an empty call.
int coco_match_instantiation(long long N, int D, int G, int A, int T) {
  return (N == 0 || D == 0 || G == 0 || A == 0 || T == 0) ? -1 : make_plan(N, D, G, A, T).regs;
}

// iou (N, D, G) float32; det_labels (N, D) int32; det_valid (N, D) bool;
// gt_labels (N, G) int32; gt_valid, gt_crowd (N, G) bool; gt_ig (N, A, G)
// bool; thr (T,) float32 (already min(t, 1 - 1e-10)); det_matched and
// det_ignored (N, A, T, D) bool, written whole; scratch:
// coco_match_scratch_words uint32 words, or null when that is 0.
int coco_match(const float* iou, const int* det_labels, const uint8_t* det_valid, const int* gt_labels,
               const uint8_t* gt_valid, const uint8_t* gt_crowd, const uint8_t* gt_ig, const float* thr,
               uint8_t* det_matched, uint8_t* det_ignored, uint32_t* scratch, long long N, int D, int G, int A, int T,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0 || D == 0 || G == 0 || A == 0 || T == 0) return 0;
  const Plan p = make_plan(N, D, G, A, T);
  switch (p.regs) {
    case 1:
      return launch<1>(p, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched,
                       det_ignored, scratch, N, D, G, A, T);
    case 2:
      return launch<2>(p, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched,
                       det_ignored, scratch, N, D, G, A, T);
    case 3:
      return launch<3>(p, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched,
                       det_ignored, scratch, N, D, G, A, T);
    case 4:
      return launch<4>(p, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched,
                       det_ignored, scratch, N, D, G, A, T);
    default:
      return launch<0>(p, stream, iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thr, det_matched,
                       det_ignored, scratch, N, D, G, A, T);
  }
}

}  // extern "C"
