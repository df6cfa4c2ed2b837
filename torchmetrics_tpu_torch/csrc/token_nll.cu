// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// token_nll: each row's negative log-likelihood of its target under the
// softmax of a row of logits, by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/functional/text/perplexity.py::_perplexity_update,
//   jax.nn.log_softmax over the (B*T, V) logits and jnp.take_along_axis of
//   one entry a row (perplexity.py:44-53). It is not a Pallas kernel (the
//   JAX package has none): XLA runs that as a reduction, an elementwise pass
//   that writes a second (B*T, V) matrix, and a gather. Here nothing of
//   size (B*T, V) is written: one pass reads each logit once.
//
// Computes, for row r of logits (n_rows, V) with a row pitch of row_stride
// elements (float32, bfloat16 or float16) and target t = target[r] (int64):
//   valid[r] = !(has_ignore && t == ignore_index)
//   nll[r]   = 0 where !valid[r]; else, with i = t + V for t < 0 (JAX's
//              wrap of negative indices), NaN where i is outside [0, V)
//              (JAX's gather fills out-of-range indices with NaN), else
//              log(sum_j exp(x_j - m)) - (x_i - m), m = max_j x_j,
//              in float32, rounded once to the logits' type;
//   lse[r]   = m + log(sum_j exp(x_j - m)) (float32; the backward's).
// A row holding a NaN or a +inf, or only -inf, gives NaN, as JAX's
// log_softmax does (x - max is NaN there).
//
// Bound on the card: the bytes. At GPT-2's shape (8,192 rows x 50,257,
// float32) the logits are 1,646,821,376 B: 0.492 ms at 3.35 TB/s (bfloat16
// 0.246 ms). The operations (a compare, an exp and an add a logit: about
// 0.4 G exps) sit well under that.
//
// Design: one block of 256 threads a row. Each thread keeps an online
// (max, sum of exp(x - max)) pair in float32 over its share of the row,
// rescaling the sum when its max moves; the row is read with 16-byte
// streaming loads (__ldcs: the logits are read once and should not displace
// L2). V is odd at GPT-2's vocabulary, so a row's start is not 16-byte
// aligned: a scalar head brings the pointer to 16 bytes, then vectors of 4
// (float32) or 8 (16-bit) values, then a scalar tail. The pairs meet by warp
// shuffles, then through shared memory; one thread reads the target's logit
// and writes the three outputs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Acc {
  float m;  // running max (never NaN)
  float s;  // sum of exp(x - m)
  int nan;  // a NaN was seen
};

__device__ __forceinline__ void push(Acc& a, float x) {
  if (x > a.m) {  // a new max: rescale the sum (exp(-inf) = 0 from the empty start)
    a.s = a.s * expf(a.m - x) + 1.0f;
    a.m = x;
  } else if (x > -INFINITY) {
    a.s += expf(x - a.m);
  } else if (x != x) {
    a.nan = 1;
  }
}

__device__ __forceinline__ Acc merge(const Acc& a, const Acc& b) {
  Acc r;
  r.nan = a.nan | b.nan;
  r.m = fmaxf(a.m, b.m);
  const float sa = a.s == 0.0f ? 0.0f : a.s * expf(a.m - r.m);  // an empty side adds nothing (-inf - -inf is NaN)
  const float sb = b.s == 0.0f ? 0.0f : b.s * expf(b.m - r.m);
  r.s = sa + sb;
  return r;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ void push_vec(Acc& a, const uint4& v, float) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  push(a, f.x);
  push(a, f.y);
  push(a, f.z);
  push(a, f.w);
}

__device__ __forceinline__ void push_vec(Acc& a, const uint4& v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    push(a, f.x);
    push(a, f.y);
  }
}

__device__ __forceinline__ void push_vec(Acc& a, const uint4& v, __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(h[k]);
    push(a, f.x);
    push(a, f.y);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) token_nll_kernel(const T* __restrict__ logits, long long row_stride,
                                                             const long long* __restrict__ target, int V,
                                                             long long ignore_index, int has_ignore,
                                                             T* __restrict__ nll, unsigned char* __restrict__ valid,
                                                             float* __restrict__ lse) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* rp = logits + row * row_stride;
  Acc acc = {-INFINITY, 0.0f, 0};

  const uintptr_t addr = reinterpret_cast<uintptr_t>(rp);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > V) head = V;
  if (static_cast<int>(threadIdx.x) < head) push(acc, to_float(rp[threadIdx.x]));
  const uint4* vp = reinterpret_cast<const uint4*>(rp + head);
  const int nvec = (V - head) / kVec;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kThreads) push_vec(acc, __ldcs(vp + i), T());
  for (int i = head + nvec * kVec + threadIdx.x; i < V; i += kThreads) push(acc, to_float(rp[i]));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc other;
    other.m = __shfl_xor_sync(0xffffffffu, acc.m, off);
    other.s = __shfl_xor_sync(0xffffffffu, acc.s, off);
    other.nan = __shfl_xor_sync(0xffffffffu, acc.nan, off);
    acc = merge(acc, other);
  }
  __shared__ Acc warp_acc[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  acc = warp_acc[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) acc = merge(acc, warp_acc[w]);

  const bool bad = acc.nan || isinf(acc.m);  // NaN, +inf, or a row of -inf alone
  const float log_s = logf(acc.s);
  lse[row] = bad ? NAN : acc.m + log_s;
  const long long t = target[row];
  const bool keep = !(has_ignore && t == ignore_index);
  valid[row] = keep;
  float out = 0.0f;
  if (keep) {
    const long long i = t < 0 ? t + V : t;
    out = (bad || i < 0 || i >= V) ? NAN : log_s - (to_float(rp[i]) - acc.m);
  }
  store(nll + row, out);
}

template <typename T>
int launch(const void* logits, long long row_stride, const long long* target, long long n_rows, int V,
           long long ignore_index, int has_ignore, void* nll, unsigned char* valid, float* lse, void* stream) {
  if (n_rows <= 0 || n_rows > 0x7fffffffLL || V < 1 || row_stride < V) return static_cast<int>(cudaErrorInvalidValue);
  token_nll_kernel<T><<<static_cast<unsigned>(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), row_stride, target, V, ignore_index, has_ignore, static_cast<T*>(nll), valid, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int token_nll_f32(const void* logits, long long row_stride, const long long* target, long long n_rows, int V,
                             long long ignore_index, int has_ignore, void* nll, unsigned char* valid, float* lse,
                             void* stream) {
  return launch<float>(logits, row_stride, target, n_rows, V, ignore_index, has_ignore, nll, valid, lse, stream);
}

extern "C" int token_nll_bf16(const void* logits, long long row_stride, const long long* target, long long n_rows,
                              int V, long long ignore_index, int has_ignore, void* nll, unsigned char* valid,
                              float* lse, void* stream) {
  return launch<__nv_bfloat16>(logits, row_stride, target, n_rows, V, ignore_index, has_ignore, nll, valid, lse, stream);
}

extern "C" int token_nll_f16(const void* logits, long long row_stride, const long long* target, long long n_rows, int V,
                             long long ignore_index, int has_ignore, void* nll, unsigned char* valid, float* lse,
                             void* stream) {
  return launch<__half>(logits, row_stride, target, n_rows, V, ignore_index, has_ignore, nll, valid, lse, stream);
}
