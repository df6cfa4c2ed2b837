// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// window_moments: the five windowed moments of two image stacks, by hand
// for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/image/ssim.py::_ssim_update, the
//   depthwise lax.conv_general_dilated over the five-way stacked input
//   (x, y, x*x, y*y, x*y) (ssim.py:114-115); the same filter is UQI's
//   (metrics.py:178-179), VIF's five convs (metrics.py:437-445) and SCC's
//   uniform-window convs (metrics.py:286-290), and MS-SSIM, D_lambda, D_s
//   and QNR reach it through SSIM and UQI. It is not a Pallas kernel (the
//   JAX package has none): XLA runs that filter as a convolution.
//
// Computes, for x and y of shape (B, C, Hp, Wp) float32 (already padded by
// the caller) and a (kh, kw) float32 weight table w, the VALID maps
// (H = Hp - kh + 1, W = Wp - kw + 1)
//   out[0] = sum_ij w[i,j] * x[h+i, w+j]             (mu_x)
//   out[1] = sum_ij w[i,j] * y[h+i, w+j]             (mu_y)
//   out[2] = sum_ij w[i,j] * (x*x)[h+i, w+j]         (E[x^2])
//   out[3] = sum_ij w[i,j] * (y*y)[h+i, w+j]         (E[y^2])
//   out[4] = sum_ij w[i,j] * (x*y)[h+i, w+j]         (E[xy])
// into out of shape (5, B, C, H, W). The taps are summed in row-major order
// (i, then j), from 0, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn: nvcc would otherwise contract a product and a sum into one
// FMA), so the result is the plain PyTorch loop's (ops/window_moments.py)
// bit for bit.
//
// Bound on the card: the bytes. At 8 x 3 x 1,356 x 2,040 the 2 maps read
// and 5 written take 0.557 ms at 3.35 TB/s. Every table the port passes is
// rank 1 (SSIM's and UQI's Gaussian is an outer product, VIF's Gaussian
// factors, the uniform windows are constant), so the least work is a
// separable window's (a row pass, then a column pass: 2 x 11 taps a moment
// at 11 x 11), about 0.22 ms at 67 TFLOP/s: the design target of a later
// version. This kernel walks the direct window: 3 products of its inputs
// and 2 x 5 operations a tap (1,213 a pixel at 121 taps), about 80.7 GFLOP,
// 1.20 ms.
//
// Design (simple and right): a block per output tile of 32 columns by
// tile_h rows (tile_h = 8, or less where a large window's halo does not fit;
// the caller picks it), a thread per output pixel. The block stages the
// tile's halo of x and y, (tile_h + kh - 1) x (32 + kw - 1) floats each, in
// dynamic shared memory (the opt-in above 48 KB is set where needed), then
// each thread walks the window over shared memory, forming x*x, y*y and x*y
// at each tap, and writes its five sums. The weights are read through the
// read-only cache: every thread of a warp reads the same tap at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;  // output columns a block: one warp wide
constexpr long long kMaxGridZ = 65535;

__global__ void __launch_bounds__(256) window_moments_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                                             const float* __restrict__ wt, float* __restrict__ out,
                                                             long long planes, long long plane0, int Hp, int Wp, int kh,
                                                             int kw) {
  extern __shared__ float smem[];
  const int tile_h = blockDim.y;
  const int halo_h = tile_h + kh - 1;
  const int halo_w = kTileW + kw - 1;
  float* sx = smem;
  float* sy = smem + halo_h * halo_w;
  const int H = Hp - kh + 1;
  const int W = Wp - kw + 1;
  const long long plane = plane0 + blockIdx.z;
  const int row0 = blockIdx.y * tile_h;
  const int col0 = blockIdx.x * kTileW;
  const float* xp = x + plane * Hp * static_cast<long long>(Wp);
  const float* yp = y + plane * Hp * static_cast<long long>(Wp);

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int nthreads = tile_h * kTileW;
  for (int k = tid; k < halo_h * halo_w; k += nthreads) {
    const int r = k / halo_w;
    const int c = k - r * halo_w;
    const int gr = row0 + r;
    const int gc = col0 + c;
    const bool in = gr < Hp && gc < Wp;
    const long long at = static_cast<long long>(gr) * Wp + gc;
    sx[k] = in ? xp[at] : 0.0f;
    sy[k] = in ? yp[at] : 0.0f;
  }
  __syncthreads();

  const int oh = row0 + threadIdx.y;
  const int ow = col0 + threadIdx.x;
  if (oh >= H || ow >= W) return;
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f, m4 = 0.0f;
  for (int i = 0; i < kh; ++i) {
    const float* rx = sx + (threadIdx.y + i) * halo_w + threadIdx.x;
    const float* ry = sy + (threadIdx.y + i) * halo_w + threadIdx.x;
    const float* rw = wt + i * kw;
    for (int j = 0; j < kw; ++j) {
      const float w = __ldg(rw + j);
      const float a = rx[j];
      const float b = ry[j];
      m0 = __fadd_rn(m0, __fmul_rn(w, a));
      m1 = __fadd_rn(m1, __fmul_rn(w, b));
      m2 = __fadd_rn(m2, __fmul_rn(w, __fmul_rn(a, a)));
      m3 = __fadd_rn(m3, __fmul_rn(w, __fmul_rn(b, b)));
      m4 = __fadd_rn(m4, __fmul_rn(w, __fmul_rn(a, b)));
    }
  }
  const long long map = planes * H * static_cast<long long>(W);
  const long long o = plane * H * static_cast<long long>(W) + static_cast<long long>(oh) * W + ow;
  out[o] = m0;
  out[o + map] = m1;
  out[o + 2 * map] = m2;
  out[o + 3 * map] = m3;
  out[o + 4 * map] = m4;
}

}  // namespace

// x, y: (planes, Hp, Wp) float32 (planes = B * C); wt: (kh, kw) float32;
// out: (5, planes, Hp - kh + 1, Wp - kw + 1) float32. tile_h (8, 4, 2 or 1)
// is the block's rows: the caller picks the largest whose halo fits.
extern "C" int window_moments(const float* x, const float* y, const float* wt, float* out, long long planes, int Hp,
                              int Wp, int kh, int kw, int tile_h, void* stream) {
  const int H = Hp - kh + 1;
  const int W = Wp - kw + 1;
  if (planes <= 0 || H <= 0 || W <= 0 || tile_h < 1 || tile_h > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(tile_h + kh - 1) * (kTileW + kw - 1);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(window_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kTileW, tile_h);
  for (long long plane0 = 0; plane0 < planes; plane0 += kMaxGridZ) {  // the grid's z extent is at most 65,535
    const long long n = planes - plane0 < kMaxGridZ ? planes - plane0 : kMaxGridZ;
    const dim3 grid((W + kTileW - 1) / kTileW, (H + tile_h - 1) / tile_h, static_cast<unsigned>(n));
    window_moments_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(x, y, wt, out, planes, plane0, Hp, Wp,
                                                                                    kh, kw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
