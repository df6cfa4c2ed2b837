// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// biquad_cascade: independent rows of float32 samples, each through a
// cascade of S biquad stages along time, by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/audio/srmr.py::_biquad, a lax.scan
//   of a transposed direct-form-II biquad over every time sample, which
//   SRMR runs for its 4-stage gammatone cascade (_erb_filterbank) and its
//   8-band modulation bank. It is not a Pallas kernel (the JAX package has
//   none): the scan ported as plain PyTorch is several launches per time
//   step, about a million per call at 10 s of 16 kHz audio.
//
// Computes, for each row r (x_row = r / group, coefficient set r % group),
// over t = 0..T-1 with z1 = z2 = 0 at the start, stage by stage at each t
// (stage s's output is stage s+1's input at the same t):
//   y  = b0 * x + z1
//   z1 = (b1 * x - a1 * y) + z2
//   z2 = b2 * x - a2 * y
// with the coefficients already divided by a0 (the caller does it in
// float32, as JAX does). Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nvcc would otherwise contract a
// product and a sum into one FMA), in the step's order, so the result is
// the plain PyTorch loop's (ops/biquad.py) bit for bit.
//
// Bound on the card: the recurrence. Each stage's y feeds its own z1 at the
// next step through an add, a multiply, a subtract and an add (four
// dependent float32 operations), so a row needs at least T such chains one
// after the other; the bytes (each input sample read once, each output
// written once) take far less at SRMR's shapes. The instructions a step
// issues (nine float32 operations a stage) exceed that latency at four
// stages, so one warp's issue rate is the floor there.
//
// Design (simple and right; a blocked parallel scan over time would be
// faster and would change the rounding order): one thread a row, 32 rows a
// block (one warp), the S stages of a sample fused in registers. The warp
// walks time in tiles of 32 samples: it loads the 32 x 32 input tile with
// neighbouring lanes on neighbouring samples (coalesced) into registers one
// tile ahead, so the loads of the next tile are in flight while this one
// steps (a block holds one warp: nothing else would hide their latency),
// takes its row of the tile from shared memory into registers (padded
// rows: no bank conflicts), steps through it there, and writes the output
// tile back through shared memory the same way, so both the
// (rows, T) input and output stay in the JAX layout. At SRMR's batch 8 the
// gammatone has 184 rows (6 warps) and the modulation bank 1,472 (46): the
// card is mostly idle, and the time is a warp's sequential walk over T.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;   // rows a block: one warp, a thread a row
constexpr int kTile = 32;   // time samples a tile
constexpr int kCoefs = 5;   // b0, b1, b2, a1, a2 of a stage

template <int S>
__device__ __forceinline__ float step(float v, const float (&c)[S][kCoefs], float (&z1)[S], float (&z2)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float y = __fadd_rn(__fmul_rn(c[s][0], v), z1[s]);
    z1[s] = __fadd_rn(__fsub_rn(__fmul_rn(c[s][1], v), __fmul_rn(c[s][3], y)), z2[s]);
    z2[s] = __fsub_rn(__fmul_rn(c[s][2], v), __fmul_rn(c[s][4], y));
    v = y;
  }
  return v;
}

template <int S>
__global__ void __launch_bounds__(kRows) biquad_cascade_kernel(const float* __restrict__ x, float* __restrict__ y,
                                                              const float* __restrict__ coefs, long long rows,
                                                              long long T, int group) {
  __shared__ float tile[kRows][kTile + 1];
  __shared__ long long in_row[kRows];
  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long row = row0 + lane;
  const bool active = row < rows;
  in_row[lane] = active ? row / group : -1;

  float c[S][kCoefs];
  float z1[S], z2[S];
  const int set = active ? static_cast<int>(row % group) : 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < kCoefs; ++k) c[s][k] = coefs[(set * S + s) * kCoefs + k];
    z1[s] = 0.0f;
    z2[s] = 0.0f;
  }
  __syncwarp();

  // the next tile's input, one sample of every row a lane (row r, sample t0 + lane)
  float next[kRows];
  auto fetch = [&](long long t0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long src = in_row[r];
      next[r] = (src >= 0 && t0 + lane < T) ? x[src * T + t0 + lane] : 0.0f;
    }
  };
  fetch(0);
  for (long long t0 = 0; t0 < T; t0 += kTile) {
    const int n = static_cast<int>(T - t0 < kTile ? T - t0 : kTile);
#pragma unroll
    for (int r = 0; r < kRows; ++r) tile[r][lane] = next[r];
    __syncwarp();
    fetch(t0 + kTile);  // in flight while this tile steps
    // the lane's row of the tile in registers, so no shared-memory access sits in the recurrence
    float v[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) v[j] = tile[lane][j];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) v[j] = step<S>(v[j], c, z1, z2);
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) tile[lane][j] = v[j];
    __syncwarp();
    const bool in_tile = lane < n;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      if (in_row[r] >= 0 && in_tile) y[(row0 + r) * T + t0 + lane] = tile[r][lane];
    }
    __syncwarp();
  }
}

template <int S>
cudaError_t launch(const float* x, float* y, const float* coefs, long long rows, long long T, int group,
                   cudaStream_t stream) {
  const long long blocks = (rows + kRows - 1) / kRows;
  biquad_cascade_kernel<S><<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(x, y, coefs, rows, T, group);
  return cudaGetLastError();
}

}  // namespace

// x: (rows / group, T) float32; y: (rows, T) float32; coefs: (group, stages, 5)
// float32 (b0, b1, b2, a1, a2 of each stage, divided by a0). stages is 1 (the
// modulation bank) or 4 (the gammatone cascade), SRMR's two banks.
extern "C" int biquad_cascade(const float* x, float* y, const float* coefs, long long rows, long long T, int group,
                              int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 1: return static_cast<int>(launch<1>(x, y, coefs, rows, T, group, s));
    case 4: return static_cast<int>(launch<4>(x, y, coefs, rows, T, group, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
