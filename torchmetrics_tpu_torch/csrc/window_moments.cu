// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// window_moments: the five windowed moments of two image stacks under a
// separable window, by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/image/ssim.py::_ssim_update, the
//   depthwise lax.conv_general_dilated over the five-way stacked input
//   (x, y, x*x, y*y, x*y) (ssim.py:114-115); the same filter is UQI's
//   (metrics.py:178-179), VIF's five convs (metrics.py:437-445) and SCC's
//   uniform-window convs (metrics.py:286-290), and MS-SSIM, D_lambda, D_s
//   and QNR reach it through SSIM and UQI. It is not a Pallas kernel (the
//   JAX package has none): XLA runs that filter as a convolution. Every
//   window those callers build is rank 1 (SSIM's and UQI's Gaussian is an
//   outer product, VIF's exp(-(a^2 + b^2)/2s^2) factors, the uniform windows
//   are constant), so the port passes the window as its two factors.
//
// Computes, for x and y of shape (B, C, Hp, Wp) float32 (already padded by
// the caller), a column factor col (kh) and a row factor row (kw), the VALID
// maps (H = Hp - kh + 1, W = Wp - kw + 1) of m = (x, y, x*x, y*y, x*y):
//   r[k][h'][w]  = sum_{j = 0..kw-1} row[j] * m_k[h'][w + j]   (the row pass)
//   out[k][h][w] = sum_{i = 0..kh-1} col[i] * r[k][h + i][w]   (the column pass)
// into out of shape (5, B, C, H, W): (mu_x, mu_y, E[x^2], E[y^2], E[xy]).
// Each sum starts from 0 and adds its taps in ascending order, each product
// and sum rounded on its own (__fmul_rn, __fadd_rn: nvcc would otherwise
// contract a product and a sum into one FMA), so the result is the plain
// PyTorch route's (ops/window_moments.py) bit for bit.
//
// Bound on the card: the bytes. At 8 x 3 x 1,356 x 2,040 with 11 x 11 taps
// the 2 maps read and 5 written take 0.557 ms at 3.35 TB/s; the separable
// sums (2 x 11 taps a moment, 2 operations a tap, x*x, y*y, x*y once an
// input) take 0.22 ms at 67 TFLOP/s. No tensor cores: TF32 would break the
// float32 sums, and the sums are too thin for mma.
//
// Design: one launch, persistent blocks (as many as fit the card at once)
// walking the (plane, tile) queue with a stride of the grid, so the number
// of planes meets no grid limit. A tile is TH output rows by 64 columns; the
// caller picks TH (ops/window_moments.py::tile_height): 48 at SSIM's 11 x 11
// (113,440 B of shared memory, two blocks an SM), fewer where a larger
// window's staged tile would not let two blocks share an SM, down to 1. A
// block of 256 threads:
//   1. stages the tile's halo of x and y, (TH + kh - 1) x (64 + kw - 1)
//      floats each, with 4-byte cp.async (any row pitch; the ragged edge
//      zero-filled);
//   2. row pass: a thread takes 4 adjacent columns of one halo row and walks
//      the row taps in runs of 4 over a register window of 7 inputs, read as
//      float4 from shared memory; x*x, y*y and x*y are formed once a run (7
//      products for 4 taps, not one a tap; the last run is its own
//      instantiation, so no branch splits it), and the five sums of its 4
//      columns stay in registers until they are written to shared memory;
//   3. issues the next tile's halo into the same buffer (the row pass was
//      its only reader), so those loads fly while
//   4. column pass: a thread takes 16 (or TH) outputs down one column of one
//      moment, and walks the row sums downward in runs of up to 16 taps over
//      a register window: one shared-memory load serves up to 16 outputs
//      (r[h + i] adds into output h at tap i, so every output still adds
//      its taps in ascending order), and writes its outputs coalesced with
//      streaming stores (the output is 2.5x the input; the input's halos
//      should stay in L2).
// The factors live in shared memory, read as broadcasts; the column
// factor's first 16 taps also in registers. Measured on an H100 (PERF.md
// §6): the passes' float32 issue, not the bytes, sets the time; a column
// run of 8 (twice the window loads) and one block an SM were slower.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 64;    // output columns a tile
constexpr int kThreads = 256;  // a block
constexpr int kRowRun = 4;     // adjacent columns a thread sums in the row pass
constexpr int kColRun = 16;    // outputs down a column a thread sums in the column pass (at most TH)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of dynamic shared memory a block stages: the factors, the halo of x and y, the five row sums
// and kColRun - 1 rows past them (the column pass reads its register window whole; what it reads past
// a moment's rows is never summed).
__host__ __device__ constexpr long long staged_floats(int th, int kh, int kw) {
  return round4(kh) + round4(kw) + 2LL * (th + kh - 1) * (kTileW + round4(kw)) + 5LL * (th + kh - 1) * kTileW +
         (kColRun - 1) * kTileW;
}

__device__ __forceinline__ void stage4(float* dst, const float* src, bool in) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(at), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Row taps j0 .. j0 + NT - 1 (NT <= kRowRun) into the five sums of kRowRun adjacent columns: the inputs
// at xr[0 .. NT + kRowRun - 2] (read as two float4), their products formed once, the taps in order.
template <int NT>
__device__ __forceinline__ void row_taps(float (&acc)[5][kRowRun], const float* xr, const float* yr, const float* w) {
  constexpr int kIn = NT + kRowRun - 1;
  const float4 xa = *reinterpret_cast<const float4*>(xr);
  const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
  const float4 ya = *reinterpret_cast<const float4*>(yr);
  const float4 yb = *reinterpret_cast<const float4*>(yr + 4);
  const float xv[2 * kRowRun] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
  const float yv[2 * kRowRun] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
  float m[5][kIn];
#pragma unroll
  for (int t = 0; t < kIn; ++t) {
    m[0][t] = xv[t];
    m[1][t] = yv[t];
    m[2][t] = __fmul_rn(xv[t], xv[t]);
    m[3][t] = __fmul_rn(yv[t], yv[t]);
    m[4][t] = __fmul_rn(xv[t], yv[t]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float c = w[j];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int n = 0; n < kRowRun; ++n) acc[k][n] = __fadd_rn(acc[k][n], __fmul_rn(c, m[k][n + j]));
    }
  }
}

template <int TH>
__global__ void __launch_bounds__(kThreads, 2)
    window_moments_kernel(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ col,
                          const float* __restrict__ row, float* __restrict__ out, long long planes, int Hp, int Wp,
                          int kh, int kw) {
  constexpr int M = TH < kColRun ? TH : kColRun;  // outputs a thread sums down a column
  constexpr int G = TH / M;                       // column groups a tile
  constexpr int kQuads = kTileW / kRowRun;        // row-pass items a halo row
  extern __shared__ float4 smem4[];
  const int H = Hp - kh + 1;
  const int W = Wp - kw + 1;
  const int hr = TH + kh - 1;              // halo rows
  const int pitch = kTileW + round4(kw);   // a halo row, a multiple of 4 floats: float4 reads stay aligned
  float* wcol = reinterpret_cast<float*>(smem4);
  float* wrow = wcol + round4(kh);
  float* hx = wrow + round4(kw);
  float* hy = hx + hr * pitch;
  float* rs = hy + hr * pitch;  // (5, hr, kTileW) row sums
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long per_plane = static_cast<long long>(tiles_x) * ((H + TH - 1) / TH);
  const long long tiles = planes * per_plane;
  const long long plane_in = static_cast<long long>(Hp) * Wp;
  const long long plane_out = static_cast<long long>(H) * W;
  const long long map = planes * plane_out;

  for (int i = tid; i < kh; i += kThreads) wcol[i] = col[i];
  for (int j = tid; j < kw; j += kThreads) wrow[j] = row[j];
  __syncthreads();
  float cw[M];  // the column factor's first M taps, kept in registers (most windows have no more)
#pragma unroll
  for (int ip = 0; ip < M; ++ip) cw[ip] = ip < kh ? wcol[ip] : 0.0f;

  auto stage = [&](long long tile) {
    const long long plane = tile / per_plane;
    const int t = static_cast<int>(tile - plane * per_plane);
    const int row0 = (t / tiles_x) * TH;
    const int col0 = (t % tiles_x) * kTileW;
    const float* xp = x + plane * plane_in;
    const float* yp = y + plane * plane_in;
    for (int r = warp; r < hr; r += kThreads / 32) {
      const int gr = row0 + r;
      for (int c = lane; c < pitch; c += 32) {
        const int gc = col0 + c;
        const bool in = gr < Hp && gc < Wp;
        const long long at = in ? static_cast<long long>(gr) * Wp + gc : 0;
        stage4(hx + r * pitch + c, xp + at, in);
        stage4(hy + r * pitch + c, yp + at, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  long long tile = blockIdx.x;
  if (tile < tiles) stage(tile);
  for (; tile < tiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the halo has landed; the previous tile's column pass is done with rs

    // Row pass: rs[k][q][w0 .. w0 + 3] for every halo row q.
    for (int item = tid; item < hr * kQuads; item += kThreads) {
      const int q = item / kQuads;
      const int w0 = (item % kQuads) * kRowRun;
      const float* xr = hx + q * pitch + w0;
      const float* yr = hy + q * pitch + w0;
      float acc[5][kRowRun];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
#pragma unroll
        for (int n = 0; n < kRowRun; ++n) acc[k][n] = 0.0f;
      }
      int j0 = 0;
      for (; j0 + kRowRun <= kw; j0 += kRowRun) row_taps<kRowRun>(acc, xr + j0, yr + j0, wrow + j0);
      switch (kw - j0) {  // the last taps, with no branch between them
        case 3: row_taps<3>(acc, xr + j0, yr + j0, wrow + j0); break;
        case 2: row_taps<2>(acc, xr + j0, yr + j0, wrow + j0); break;
        case 1: row_taps<1>(acc, xr + j0, yr + j0, wrow + j0); break;
        default: break;
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        *reinterpret_cast<float4*>(rs + (k * hr + q) * kTileW + w0) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      }
    }
    __syncthreads();  // rs is complete; the halo buffer is free

    const long long next = tile + gridDim.x;
    if (next < tiles) stage(next);

    // Column pass: M outputs down column w of moment k, rows row0 + g * M ...
    const long long plane = tile / per_plane;
    const int t = static_cast<int>(tile - plane * per_plane);
    const int row0 = (t / tiles_x) * TH;
    const int col0 = (t % tiles_x) * kTileW;
    for (int item = tid; item < 5 * G * kTileW; item += kThreads) {
      const int w = item % kTileW;
      const int g = (item / kTileW) % G;
      const int k = item / (kTileW * G);
      const float* rc = rs + (k * hr + g * M) * kTileW + w;
      float acc[M];
#pragma unroll
      for (int mm = 0; mm < M; ++mm) acc[mm] = 0.0f;
      // Taps i0 .. i0 + taps - 1 over a register window of the row sums r[h + i0 .. h + i0 + 2M - 2].
      auto col_taps = [&](int i0, int taps, auto weight) {
        float win[2 * M - 1];
#pragma unroll
        for (int s = 0; s < 2 * M - 1; ++s) win[s] = rc[(i0 + s) * kTileW];
#pragma unroll
        for (int ip = 0; ip < M; ++ip) {
          if (ip < taps) {
            const float c = weight(ip);
#pragma unroll
            for (int mm = 0; mm < M; ++mm) acc[mm] = __fadd_rn(acc[mm], __fmul_rn(c, win[mm + ip]));
          }
        }
      };
      col_taps(0, kh < M ? kh : M, [&](int ip) { return cw[ip]; });
      for (int i0 = M; i0 < kh; i0 += M) col_taps(i0, kh - i0 < M ? kh - i0 : M, [&](int ip) { return wcol[i0 + ip]; });
      const int ow = col0 + w;
      const int oh = row0 + g * M;
      if (ow < W && oh < H) {
        const int rows = H - oh;
        float* o = out + k * map + plane * plane_out + static_cast<long long>(oh) * W + ow;
#pragma unroll
        for (int mm = 0; mm < M; ++mm, o += W) {
          if (mm < rows) __stcs(o, acc[mm]);
        }
      }
    }
  }
}

template <int TH>
cudaError_t launch(const float* x, const float* y, const float* col, const float* row, float* out, long long planes,
                   int Hp, int Wp, int kh, int kw, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(staged_floats(TH, kh, kw));
  cudaError_t err = cudaFuncSetAttribute(window_moments_kernel<TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_moments_kernel<TH>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int H = Hp - kh + 1;
  const int W = Wp - kw + 1;
  const long long tiles = planes * ((W + kTileW - 1) / kTileW) * static_cast<long long>((H + TH - 1) / TH);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  window_moments_kernel<TH><<<blocks, kThreads, smem, stream>>>(x, y, col, row, out, planes, Hp, Wp, kh, kw);
  return cudaGetLastError();
}

}  // namespace

// x, y: (planes, Hp, Wp) float32 (planes = B * C); col: (kh,) float32; row:
// (kw,) float32; out: (5, planes, Hp - kh + 1, Wp - kw + 1) float32. tile_h
// (48, 32, 16, 8, 4, 2 or 1) is a tile's output rows, picked by the caller
// from the staged floats (staged_floats) a block needs.
extern "C" int window_moments(const float* x, const float* y, const float* col, const float* row, float* out,
                              long long planes, int Hp, int Wp, int kh, int kw, int tile_h, void* stream) {
  if (planes <= 0 || kh < 1 || kw < 1 || Hp < kh || Wp < kw) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_h) {
    case 48: return static_cast<int>(launch<48>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    case 32: return static_cast<int>(launch<32>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    case 16: return static_cast<int>(launch<16>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    case 8: return static_cast<int>(launch<8>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    case 4: return static_cast<int>(launch<4>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    case 2: return static_cast<int>(launch<2>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    case 1: return static_cast<int>(launch<1>(x, y, col, row, out, planes, Hp, Wp, kh, kw, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
