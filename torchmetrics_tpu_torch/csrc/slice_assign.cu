// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// slice_assign: the sliced plan's slice table, one batch of cohort keys
// placed in it, by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/parallel/sliced.py::_assign_cells (with
//   ::_hash_rows), a plain-JAX device loop: a lax.while_loop whose trip
//   count depends on the data. The JAX package has no Pallas kernel for it.
//   A CUDA graph cannot hold a loop whose trip count the host would have to
//   read, so the rounds run inside one block.
//
// The table is keys (N, W) int32, occupied (N,) bool and spills () int32,
// updated in place; the batch is kmat (B, W) int32; the result is
// cells (B,) int32, the cell of each row or -1 for a row that spilled.
// Bit for bit JAX's algorithm:
//   h0[r] = murmur3-style mix of row r's W key columns (uint32 arithmetic
//           that wraps) % N;
//   resident lookup: the cell holding row r's key, if any;
//   rounds j = 0, 1, ... while a row is unresolved and j < N: an unresolved
//   row probes slot (h0 + j) % N; an occupied slot holding its key resolves
//   it; rows probing an empty slot contend for it and the lowest row index
//   claims it (its key is written, the slot occupied); a contender holding
//   the winner's key lands in the same round, the others probe on.
//   Rows still unresolved after the last round are spilled (-1) and counted
//   into spills.
// The lookup walks each row's probe chain from h0 to its key or to the
// first empty slot. JAX compares the key with every resident key instead;
// the two agree because the table never deletes and a key is only ever
// written at the first slot of its chain that was empty: every slot between
// h0 and a resident key's cell stays occupied.
//
// Bound on the card: bytes. The keys are read once (4 W bytes a row), the
// cells written once (4 bytes a row), the table read once: at B = 65536,
// W = 1, N = 256, about 0.53 MB, 0.16 us at 3.35 TB/s. The hash and the
// compares are a few tens of integer operations a row.
//
// Design: two launches on the caller's stream. The lookup runs over the
// rows in as many blocks as the batch needs, writes each row's h0 and
// resident cell, and counts the rows it left unresolved. The rounds run in
// one block of 1024 threads, which strides over the rows in three phases a
// round, __syncthreads between them: (A) resolve on a matching occupied
// slot, else atomicMin the row index into the slot's claim word; (B) the
// row whose index the claim word holds writes its key and occupies the
// slot; (C) the other contenders compare their key with the slot's. The
// claim words live in shared memory (in global scratch past 12288 cells)
// and are reset after every round. The block returns at once when the
// lookup left nothing unresolved: in steady state (every cohort resident)
// the rounds cost one launch and one read. Allocates nothing (the caller
// passes the scratch, its counter zeroed) and returns the launch's error.
#include <cuda_runtime.h>

namespace {

constexpr int kLookupThreads = 256;
constexpr int kRoundThreads = 1024;
constexpr int kNoClaim = 0x7fffffff;
constexpr int kMaxSmemClaims = 12288;  // 48 KB of claim words

__device__ __forceinline__ unsigned rotl32(unsigned x, int r) { return (x << r) | (x >> (32 - r)); }

// JAX's _hash_rows: a murmur3-style mix of the key columns, then fmix32
__device__ __forceinline__ unsigned hash_row(const int* __restrict__ k, int w) {
  unsigned h = 0x811C9DC5u;
  for (int i = 0; i < w; ++i) {
    unsigned x = static_cast<unsigned>(k[i]) * 0xCC9E2D51u;
    x = rotl32(x, 15) * 0x1B873593u;
    h = rotl32(h ^ x, 13) * 5u + 0xE6546B64u;
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ bool same_key(const int* a, const int* __restrict__ b, int w) {
  for (int i = 0; i < w; ++i) {
    if (a[i] != b[i]) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kLookupThreads) slice_lookup_kernel(
    const int* __restrict__ kmat, int w, long long b, const int* __restrict__ keys,
    const unsigned char* __restrict__ occupied, int n, int* __restrict__ h0, int* __restrict__ cells,
    int* __restrict__ unresolved) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int miss = 0;
  if (r < b) {
    const int* k = kmat + r * w;
    const int h = static_cast<int>(hash_row(k, w) % static_cast<unsigned>(n));
    h0[r] = h;
    int cell = -1;
    int s = h;
    for (int j = 0; j < n; ++j) {
      if (!occupied[s]) break;
      if (same_key(keys + static_cast<long long>(s) * w, k, w)) {
        cell = s;
        break;
      }
      if (++s == n) s = 0;
    }
    cells[r] = cell;
    miss = cell < 0;
  }
  const unsigned misses = __ballot_sync(0xffffffffu, miss);
  if ((threadIdx.x & 31) == 0 && misses) atomicAdd(unresolved, __popc(misses));
}

__global__ void __launch_bounds__(kRoundThreads) slice_rounds_kernel(
    const int* __restrict__ kmat, int w, long long b, int* keys, unsigned char* occupied, int n,
    const int* __restrict__ h0, int* cells, const int* __restrict__ unresolved, int* __restrict__ spills,
    int* global_claim) {
  extern __shared__ int s_claim[];
  if (*unresolved == 0) return;  // every row found its cohort resident
  int* claim = n <= kMaxSmemClaims ? s_claim : global_claim;
  for (int i = threadIdx.x; i < n; i += blockDim.x) claim[i] = kNoClaim;
  __syncthreads();
  int any = 1;
  for (int j = 0; j < n && any; ++j) {
    // (A) resolve on the slot's resident key, or claim the empty slot
    for (long long r = threadIdx.x; r < b; r += blockDim.x) {
      if (cells[r] >= 0) continue;
      int s = h0[r] + j;
      if (s >= n) s -= n;
      if (occupied[s]) {
        if (same_key(keys + static_cast<long long>(s) * w, kmat + r * w, w)) cells[r] = s;
      } else {
        atomicMin(&claim[s], static_cast<int>(r));
      }
    }
    __syncthreads();
    // (B) the lowest contending row takes the slot
    for (long long r = threadIdx.x; r < b; r += blockDim.x) {
      if (cells[r] >= 0) continue;
      int s = h0[r] + j;
      if (s >= n) s -= n;
      if (claim[s] == static_cast<int>(r)) {
        for (int i = 0; i < w; ++i) keys[static_cast<long long>(s) * w + i] = kmat[r * w + i];
        occupied[s] = 1;
        cells[r] = s;
      }
    }
    __syncthreads();
    // (C) contenders holding the winner's key land in the same round
    for (long long r = threadIdx.x; r < b; r += blockDim.x) {
      if (cells[r] >= 0) continue;
      int s = h0[r] + j;
      if (s >= n) s -= n;
      if (claim[s] != kNoClaim && same_key(keys + static_cast<long long>(s) * w, kmat + r * w, w)) cells[r] = s;
    }
    __syncthreads();
    int open = 0;
    for (long long r = threadIdx.x; r < b; r += blockDim.x) open |= cells[r] < 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) claim[i] = kNoClaim;
    any = __syncthreads_or(open);
  }
  int spilled = 0;
  for (long long r = threadIdx.x; r < b; r += blockDim.x) spilled += cells[r] < 0;
  if (spilled) atomicAdd(spills, spilled);
}

}  // namespace

// kmat: (b, w) int32; keys: (n, w) int32; occupied: (n,) bool; spills: ()
// int32; cells: (b,) int32 out; scratch: (b + 1 + (n > 12288 ? n : 0))
// int32, scratch[b] zeroed (the lookup's count of unresolved rows).
extern "C" int slice_assign(const void* kmat, int w, long long b, void* keys, void* occupied, int n, void* spills,
                            void* cells, void* scratch, void* stream) {
  if (b == 0) return 0;
  auto stream_ = static_cast<cudaStream_t>(stream);
  auto* h0 = static_cast<int*>(scratch);
  int* unresolved = h0 + b;
  int* global_claim = unresolved + 1;
  const auto* kmat_ = static_cast<const int*>(kmat);
  auto* keys_ = static_cast<int*>(keys);
  auto* occ_ = static_cast<unsigned char*>(occupied);
  auto* cells_ = static_cast<int*>(cells);
  const long long blocks = (b + kLookupThreads - 1) / kLookupThreads;
  slice_lookup_kernel<<<static_cast<unsigned>(blocks), kLookupThreads, 0, stream_>>>(kmat_, w, b, keys_, occ_, n, h0,
                                                                                  cells_, unresolved);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = n <= kMaxSmemClaims ? static_cast<size_t>(n) * sizeof(int) : 0;
  slice_rounds_kernel<<<1, kRoundThreads, smem, stream_>>>(kmat_, w, b, keys_, occ_, n, h0, cells_, unresolved,
                                                          static_cast<int*>(spills), global_claim);
  return cudaGetLastError();
}
