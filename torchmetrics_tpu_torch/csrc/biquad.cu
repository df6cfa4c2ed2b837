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
// dependent float32 operations, 4 cycles each), so a row needs at least T
// such 16-cycle chains one after the other: 1.29 ms at T = 160,000 and
// 1,980 MHz, for one stage or four (a probe running the step on registers
// alone takes 16.56 cycles a step on an H100: chip_k5_variants.py). The
// bytes (each input sample read once, each output written once) take far
// less at SRMR's shapes. A row's steps cannot be regrouped (a blocked scan)
// without changing the rounding, so the design aims at that chain: a stage
// issues 9 float32 operations a step, under 16 cycles, on a scheduler of
// its own, and nothing else it issues waits on memory.
//
// Design: a block owns 32 rows and walks time in tiles of kTile samples,
// with a warp for each stage and two for the bytes (S + 2 warps; warp w
// issues on scheduler w % 4, so no two stages share one). Tiles pass from
// warp to warp through rings of kRing tiles in shared memory (rows padded
// to kPitch floats: float4 accesses free of bank conflicts), each tile
// guarded by a "full" and an "empty" mbarrier that expect a warp's 32
// lanes:
//   - warp S, the loader, copies each tile of the block's distinct input
//     rows (2-3 for the gammatone's 23 sets, 4 for the modulation bank's 8,
//     32 for group 1) with 4-byte cp.async (any T; zeros past T) into ring
//     0, each lane's copies arriving on the tile's "full" barrier as they
//     land (cp.async.mbarrier.arrive.noinc);
//   - warp s < S runs stage s, a lane a row, its 5 coefficients and z1, z2
//     in registers, from ring s into ring s + 1. A tile is one block of 16
//     quads of 4 steps (stage_block): each quad's inputs are loaded kAhead
//     quads before its step and its outputs stored kAhead quads after, so
//     the loads and stores, kept in order (volatile), fall among the steps
//     rather than in a burst at either end of the tile. The block's slots
//     were polled without blocking (mbarrier.test_wait) in the block
//     before, which also loaded the tile's first kAhead quads on the
//     poll's word; a slot found not ready is waited for at the block's
//     start and the head loaded again;
//   - warp S + 1, the storer, writes each finished tile of ring S to y,
//     neighbouring lanes on neighbouring samples (float4 where T is a
//     multiple of 4, else a float a lane).
// No step is guarded: the last tile runs whole on zero-filled input past T,
// whose outputs only follow every stored output in time and are never
// stored. Lanes past the block's last row step on row 0's input and take
// part in every barrier. The stages run a pipeline about two tiles apart;
// a ring of 4 leaves the polls about two tiles of slack (one of 2 also
// works, more slowly).
// The arithmetic of a step is the same op for op as the plain loop's, with
// the same roundings, so the result is the plain loop's bit for bit
// (NaNs and denormals included: no flush to zero).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 32;          // rows a block: a lane a row in each stage's warp
constexpr int kTile = 64;          // time samples a tile
constexpr int kPitch = kTile + 4;  // floats a row of a staged tile: 16-byte rows, float4 reads free of bank conflicts
constexpr int kTileFloats = kRows * kPitch;
constexpr uint32_t kTileBytes = kTileFloats * sizeof(float);
constexpr int kRing = 4;           // tiles a ring holds (a power of two)
constexpr int kCoefs = 5;          // b0, b1, b2, a1, a2 of a stage
constexpr int kQuads = kTile / 4;  // quads of a tile
constexpr int kAhead = 4;          // quads between a quad's load and its step, and between its step and its store
constexpr int kCarry = 4 * kAhead;  // samples of a tile's head and tail, carried between blocks
static_assert(kTile % 32 == 0 && kTile <= 128, "a tile is whole warps of samples, and a row of it at most 32 float4");
static_assert(kQuads >= 2 * kAhead, "a block loads its tile's quads past the head and stores them before the tail");

// Dynamic shared memory of the S-stage kernel: S + 1 rings of kRing tiles (the input, one between each
// two stages, the output), then a "full" and an "empty" mbarrier for each tile of each ring.
template <int S>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(S + 1) * kRing * (kTileBytes + 2 * sizeof(uint64_t));
}

// Shared memory is addressed by 32-bit shared-window addresses, computed once a warp.
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One poll of `bar` that never blocks: 1 if the phase with this parity has completed.
__device__ __forceinline__ uint32_t bar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\tmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// The phase parity of tile k's round in a ring.
__device__ __forceinline__ uint32_t parity(int k) { return (static_cast<uint32_t>(k) / kRing) & 1; }

__device__ __forceinline__ void copy4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Arrives on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A quad of a staged row: ordered shared-memory accesses (volatile), so a tile's loads and stores keep
// the places the walk gives them among its steps.
__device__ __forceinline__ void load4(float* v, uint32_t at) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(at)
               : "memory");
}

__device__ __forceinline__ void store4(uint32_t at, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// A ring in shared memory: its slot 0's tile and its slot 0's two barriers (slot s: + s * kTileBytes, + s * 8).
struct Ring {
  uint32_t tiles, full, empty;
};

__device__ __forceinline__ Ring ring(uint32_t base, int rings, int i) {
  const uint32_t bars = base + rings * kRing * kTileBytes;
  return {base + i * kRing * kTileBytes, bars + i * kRing * 8, bars + (rings + i) * kRing * 8};
}

struct Coefs {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ float step(float v, const Coefs& c, float& z1, float& z2) {
  const float y = __fadd_rn(__fmul_rn(c.b0, v), z1);
  z1 = __fadd_rn(__fsub_rn(__fmul_rn(c.b1, v), __fmul_rn(c.a1, y)), z2);
  z2 = __fsub_rn(__fmul_rn(c.b2, v), __fmul_rn(c.a2, y));
  return y;
}

// What a stage's lane carries along its walk over time.
struct Walk {
  Ring in, out;
  uint32_t in_row, out_row;  // the lane's row of slot 0 in each ring
  Coefs c;
  float z1, z2;
  int tiles;
  uint32_t polled;  // 1 if this block's input tile and output slot were found ready in the block before
};

// Block k of a stage's walk: tile k's 64 steps, a quad at a time, each quad's inputs loaded kAhead quads
// before its step and its outputs stored kAhead quads after. On entry `head` holds tile k's first kCarry
// inputs, loaded at the end of the block before on the strength of a poll, and `tail` tile k - 1's last
// kCarry outputs (none when `First`); on exit tile k + 1's head and tile k's tail. If the poll had not
// found input tile k and output slot k ready, the block waits for them and loads the head again. Every
// load but the next head's has its step in the block and every store its step before it, so the ordered
// loads and stores spread over the steps, and the block's one branch is at its start.
template <bool First>
__device__ __forceinline__ void stage_block(Walk& w, int k, float (&head)[kCarry], float (&tail)[kCarry]) {
  const uint32_t slot = static_cast<uint32_t>(k) & (kRing - 1);
  const uint32_t next_slot = static_cast<uint32_t>(k + 1) & (kRing - 1);
  const uint32_t src = w.in_row + slot * kTileBytes;
  const uint32_t next_src = w.in_row + next_slot * kTileBytes;
  const uint32_t dst = w.out_row + slot * kTileBytes;
  if (!w.polled) {
    bar_wait(w.in.full + slot * 8, parity(k));
    bar_wait(w.out.empty + slot * 8, parity(k) ^ 1);
#pragma unroll
    for (int j = 0; j < kCarry; j += 4) load4(head + j, src + j * 4);
  }
  if (!First) {
    const uint32_t prev_slot = static_cast<uint32_t>(k - 1) & (kRing - 1);
#pragma unroll
    for (int j = 0; j < kCarry; j += 4) store4(w.out_row + prev_slot * kTileBytes + (kTile - kCarry + j) * 4, tail + j);
    bar_arrive(w.out.full + prev_slot * 8);  // tile k - 1 is all stored
  }
  float v[kTile], y[kTile];
#pragma unroll
  for (int i = 0; i < kCarry; ++i) v[i] = head[i];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int j = 4 * q;
    if (q == kQuads - kAhead) {  // the next block's slots, polled just before its head is loaded
      w.polled = bar_test(w.in.full + next_slot * 8, parity(k + 1)) &
                 bar_test(w.out.empty + next_slot * 8, parity(k + 1) ^ 1);
    }
    if (q >= kAhead) store4(dst + (j - kCarry) * 4, y + j - kCarry);
    if (q < kQuads - kAhead) {
      load4(v + j + kCarry, src + (j + kCarry) * 4);
    } else {
      load4(head + j + kCarry - kTile, next_src + (j + kCarry - kTile) * 4);  // tile k + 1's head, on the poll's word
    }
#pragma unroll
    for (int i = j; i < j + 4; ++i) y[i] = step(v[i], w.c, w.z1, w.z2);
    if (q == kQuads - kAhead - 1) bar_arrive(w.in.empty + slot * 8);  // tile k is all loaded
  }
#pragma unroll
  for (int i = 0; i < kCarry; ++i) tail[i] = y[kTile - kCarry + i];
}

// A stage's walk over every tile, then the last tile's tail.
__device__ __forceinline__ void stage_walk(Walk& w) {
  float head[kCarry], tail[kCarry];
  stage_block<true>(w, 0, head, tail);
  for (int k = 1; k < w.tiles; ++k) stage_block<false>(w, k, head, tail);
  const uint32_t slot = static_cast<uint32_t>(w.tiles - 1) & (kRing - 1);
#pragma unroll
  for (int j = 0; j < kCarry; j += 4) store4(w.out_row + slot * kTileBytes + (kTile - kCarry + j) * 4, tail + j);
  bar_arrive(w.out.full + slot * 8);
}

template <int S>
__global__ void __launch_bounds__((S + 2) * 32, 1)
    biquad_cascade_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ coefs,
                          long long rows, long long T, int group) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int live = static_cast<int>(rows - row0 < kRows ? rows - row0 : kRows);  // rows of this block
  const long long in0 = row0 / group;                                            // its first input row
  const int distinct = static_cast<int>((row0 + live - 1) / group - in0) + 1;    // input rows it reads
  const int tiles = static_cast<int>((T + kTile - 1) / kTile);
  if (threadIdx.x == 0) {
    const Ring first = ring(base, S + 1, 0);
    for (int i = 0; i < 2 * (S + 1) * kRing; ++i) bar_init(first.full + i * 8, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < S) {  // stage `warp`, a lane a row
    const bool active = lane < live;
    const long long row = row0 + lane;
    const int set = active ? static_cast<int>(row % group) : 0;
    const float* cs = coefs + (set * S + warp) * kCoefs;
    const Ring in = ring(base, S + 1, warp);
    const Ring out = ring(base, S + 1, warp + 1);
    // stage 0 reads the lane's input row among the block's distinct ones, the others the lane's row
    const int src = warp > 0 ? lane : (active ? static_cast<int>(row / group - in0) : 0);
    Walk w = {in, out, in.tiles + src * kPitch * 4, out.tiles + lane * kPitch * 4, {cs[0], cs[1], cs[2], cs[3], cs[4]},
              0.0f, 0.0f, tiles, 0};
    stage_walk(w);
  } else if (warp == S) {  // the loader: the distinct input rows of each tile into ring 0
    const Ring in = ring(base, S + 1, 0);
    for (int k = 0; k < tiles; ++k) {
      const uint32_t slot = static_cast<uint32_t>(k) & (kRing - 1);
      bar_wait(in.empty + slot * 8, parity(k) ^ 1);
      const long long t0 = static_cast<long long>(k) * kTile;
      const float* src = x + in0 * T + t0 + lane;
      uint32_t dst = in.tiles + slot * kTileBytes + lane * 4;
      for (int d = 0; d < distinct; ++d, src += T, dst += kPitch * 4) {
#pragma unroll
        for (int j = 0; j < kTile; j += 32) {
          const bool in_row = t0 + j + lane < T;
          copy4(dst + j * 4, in_row ? src + j : x, in_row);
        }
      }
      copies_arrive(in.full + slot * 8);
    }
  } else {  // the storer: each finished tile of ring S into y
    const Ring out = ring(base, S + 1, S);
    const float* tiles_S = smem + S * kRing * kTileFloats;
    const bool vec = (T & 3) == 0;
    const int sub = lane / kQuads, col = (lane % kQuads) * 4;  // float4 stores: 32 / kQuads rows an instruction
    for (int k = 0; k < tiles; ++k) {
      const uint32_t slot = static_cast<uint32_t>(k) & (kRing - 1);
      bar_wait(out.full + slot * 8, parity(k));
      const long long t0 = static_cast<long long>(k) * kTile;
      const float* tile = tiles_S + slot * kTileFloats;
      if (vec && t0 + kTile <= T) {
        float* dst = y + (row0 + sub) * T + t0 + col;
#pragma unroll 4
        for (int r = sub; r < kRows; r += 32 / kQuads, dst += (32 / kQuads) * T) {
          if (r < live) *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(tile + r * kPitch + col);
        }
      } else {
        float* dst = y + row0 * T + t0 + lane;
        for (int r = 0; r < live; ++r, dst += T) {
#pragma unroll
          for (int j = 0; j < kTile; j += 32) {
            if (t0 + j + lane < T) dst[j] = tile[r * kPitch + j + lane];
          }
        }
      }
      bar_arrive(out.empty + slot * 8);
    }
  }
}

template <int S>
cudaError_t launch(const float* x, float* y, const float* coefs, long long rows, long long T, int group,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<S>();
  cudaError_t err = cudaFuncSetAttribute(biquad_cascade_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + kRows - 1) / kRows;
  biquad_cascade_kernel<S><<<static_cast<unsigned>(blocks), (S + 2) * 32, smem, stream>>>(x, y, coefs, rows, T, group);
  return cudaGetLastError();
}

}  // namespace

// x: (rows / group, T) float32; y: (rows, T) float32; coefs: (group, stages, 5)
// float32 (b0, b1, b2, a1, a2 of each stage, divided by a0). stages is 1 (the
// modulation bank) or 4 (the gammatone cascade), SRMR's two banks.
extern "C" int biquad_cascade(const float* x, float* y, const float* coefs, long long rows, long long T, int group,
                              int stages, void* stream) {
  if (rows <= 0 || T <= 0 || group < 1 || (T + kTile - 1) / kTile > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 1: return static_cast<int>(launch<1>(x, y, coefs, rows, T, group, s));
    case 4: return static_cast<int>(launch<4>(x, y, coefs, rows, T, group, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
