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
//   Rows still unresolved after the last round are spilled (-1) and counted,
//   by rows, into spills.
// The lookup walks each row's probe chain from h0 to its key or to the
// first empty slot. JAX compares the key with every resident key instead;
// the two agree because the table never deletes and a key is only ever
// written at the first slot of its chain that was empty: every slot between
// h0 and a resident key's cell stays occupied.
//
// The rounds run over one representative per distinct key, its lowest row,
// and give its cell to every row of the key. That is JAX's rounds bit for
// bit. Rows with one key share h0 and so probe the same slot each round;
// an occupied slot holds one key, so they match it or not together; of the
// contenders for an empty slot the lowest row wins, and the lowest row of a
// key is its representative, so the winner among rows is the lowest winner
// among representatives; the rows holding the winner's key land with it
// (JAX's third step), every other row of a key probes on with it. So all
// rows of a key resolve in one round to one cell, or spill together. Among
// representatives, which hold distinct keys, JAX's third step never fires,
// and neither does a match in its first: a key the lookup did not find is
// in the table only once its own representative wrote it. Once no slot is
// empty nothing can change, so the rounds stop there; the rows left spill,
// as after JAX's last round.
//
// Bound on the card: bytes. The keys are read once (4 W bytes a row), the
// cells written once (4 bytes a row), the table read once: at B = 65536,
// W = 1, N = 256, about 0.53 MB, 0.16 us at 3.35 TB/s. The hash and the
// compares are a few tens of integer operations a row. A batch that brings
// new keys adds the rounds, a chain of dependent steps in one block.
//
// Design: one launch on the caller's stream, about two blocks per SM.
// - A thread a row walks the row's probe chain in the table (global memory,
//   cached) and writes its cell.
// - A row the lookup left unresolved goes into a hash on its key, in a
//   buffer kept with the table between calls: a slot holds (generation,
//   row) in 64 bits, a compare-and-swap takes a slot of an older generation
//   (empty for this call) and appends it to the call's list of new keys, an
//   atomicMin keeps the lowest row of a key. The generation is ctrl[4] + 1,
//   so the hash needs no clearing between calls.
// - The last block to finish, found by an atomic ticket, runs the rounds
//   when a row missed: the table staged in shared memory where it fits in
//   96 KB (keys, occupancy and the claim words), one representative a new
//   key read from its slot (its row, h0, cell, slot and first key column in
//   shared memory up to 2048 of them, else in global scratch), atomicMin
//   claims and a barrier a step. Rounds in which no unresolved
//   representative reaches an empty slot change nothing, so each step first
//   finds, over the representatives, the fewest rounds until one does and
//   skips them. Each representative's cell goes into a cell array beside its
//   slot. The block zeroes the ticket and the counters, leaves the
//   representatives and the rounds (skipped ones included) in ctrl[2] and
//   ctrl[3], and publishes the generation in ctrl[4].
// - Every block that had a miss waits for that, then gives each of its
//   unresolved rows the cell of its key's slot and adds its spilled rows to
//   spills. (It cannot wait for a block that has not started: the last
//   block takes its ticket after every other block.)
// In steady state (every cohort resident) a call is the one launch, no
// memset, no fence. Allocates nothing and returns the launch's error.
#include <cuda_runtime.h>

#include <algorithm>

#include "_launch.cuh"

namespace {

using hist_launch::kMaxDevices;
using hist_launch::LaunchCache;

constexpr int kThreadsK4 = 512;
constexpr int kNoClaim = 0x7fffffff;
constexpr int kRepsSmem = 2048;               // representatives whose state (5 words) lives in shared memory
constexpr size_t kTableSmemMax = 96 * 1024;   // the table staged in shared memory up to this

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

// A claim word, in shared memory or (read past L1, since atomics change it) in global memory.
__device__ __forceinline__ int claim_of(const int* claim, int s, bool staged) { return staged ? claim[s] : __ldcg(claim + s); }

// Does slot s of the table hold the key of row r (its first column first)?
__device__ __forceinline__ bool own_key(const int* tkeys, int s, int w, int key0, const int* __restrict__ kmat, int r) {
  const int* slot_key = tkeys + static_cast<long long>(s) * w;
  return (w == 0 || slot_key[0] == key0) && same_key(slot_key, kmat + static_cast<long long>(r) * w, w);
}

using u64 = unsigned long long;
__device__ __forceinline__ unsigned gen_of(u64 v) { return static_cast<unsigned>(v >> 32); }
__device__ __forceinline__ int row_of(u64 v) { return static_cast<int>(static_cast<unsigned>(v)); }

// The slot of key row r in the hash of generation g, inserting it if new
// (the slot's index appended to fresh[]); the slot keeps the key's lowest row.
__device__ __forceinline__ void hash_insert(const int* __restrict__ kmat, int w, int r, unsigned g, u64* hash, int mask,
                                            int* fresh, int* n_fresh) {
  const int* key = kmat + static_cast<long long>(r) * w;
  const u64 mine = (static_cast<u64>(g) << 32) | static_cast<unsigned>(r);
  unsigned s = hash_row(key, w) & mask;
  for (;;) {
    u64 v = __ldcg(hash + s);
    if (gen_of(v) != g) {
      const u64 old = atomicCAS(hash + s, v, mine);
      if (old == v) {
        fresh[atomicAdd(n_fresh, 1)] = static_cast<int>(s);
        return;
      }
      v = old;  // taken in this call meanwhile
    }
    if (same_key(kmat + static_cast<long long>(row_of(v)) * w, key, w)) {
      atomicMin(hash + s, mine);
      return;
    }
    s = (s + 1) & mask;
  }
}

// The slot of key row r's key in the hash of generation g (inserted before).
__device__ __forceinline__ unsigned hash_find(const int* __restrict__ kmat, int w, int r, const u64* hash, int mask) {
  const int* key = kmat + static_cast<long long>(r) * w;
  unsigned s = hash_row(key, w) & mask;
  while (!same_key(kmat + static_cast<long long>(row_of(__ldcg(hash + s))) * w, key, w)) s = (s + 1) & mask;
  return s;
}

// ctrl (8 int32, kept with the table): [0] the ticket, [1] a row missed,
// [5] new keys (all three zero between calls), [2] representatives and
// [3] rounds of the last insertion, [4] the generation of the key hash.
// hash: (mask + 1) u64 slots, kept with ctrl, mask + 1 >= 2 b a power of
// two. scratch: the new keys' slots (b), the cells of the hash slots
// (mask + 1), the representatives' state past 2048 (5 b), the claim words
// of an unstaged table (n).
__global__ void __launch_bounds__(kThreadsK4) slice_assign_kernel(
    const int* __restrict__ kmat, int w, long long b, int* keys, unsigned char* occupied, int n, int staged,
    int* __restrict__ spills, int* __restrict__ cells, int* ctrl, u64* hash, int mask, int* scratch) {
  extern __shared__ int smem[];  // the last block's: representatives (5 x kRepsSmem), the staged keys, claims, occupancy
  __shared__ int s_last, s_free, s_skip, s_spilled, s_hit[2];
  int* fresh = scratch;
  int* hcell = fresh + b;
  int* g_rep = hcell + mask + 1;
  // nothing moves ctrl[4] before every block has taken its ticket, so every thread reads one generation
  const unsigned g = static_cast<unsigned>(__ldcg(ctrl + 4)) + 1u;
  if (threadIdx.x == 0) s_spilled = 0;

  // the lookup, and every unresolved row's key into the hash
  int missed = 0;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < b;
       r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int* k = kmat + r * w;
    int s = static_cast<int>(hash_row(k, w) % static_cast<unsigned>(n));
    int cell = -1;
    for (int j = 0; j < n; ++j) {
      if (!occupied[s]) break;
      if (same_key(keys + static_cast<long long>(s) * w, k, w)) {
        cell = s;
        break;
      }
      if (++s == n) s = 0;
    }
    cells[r] = cell;
    if (cell < 0) {
      missed = 1;
      hash_insert(kmat, w, static_cast<int>(r), g, hash, mask, fresh, ctrl + 5);
    }
  }
  if (missed) __threadfence();  // this thread's new keys, before the block's ticket
  const bool block_missed = __syncthreads_or(missed);
  if (threadIdx.x == 0) {
    if (block_missed) {
      atomicExch(ctrl + 1, 1);
      __threadfence();
    }
    s_last = atomicAdd(ctrl, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();

  if (s_last) {
    // the last block: every other block has inserted its keys
    if (threadIdx.x == 0) s_last = atomicAdd(ctrl + 1, 0) ? atomicAdd(ctrl + 5, 0) : 0;
    __syncthreads();
    const int R = s_last;
    if (R == 0) {  // every row found its cohort resident
      if (threadIdx.x == 0) ctrl[0] = ctrl[2] = ctrl[3] = 0;
      return;
    }
    int* s_keys = smem + 5 * kRepsSmem;
    int* s_claim = s_keys + n * w;
    auto* s_occ = reinterpret_cast<unsigned char*>(s_claim + n);
    int* tkeys = staged ? s_keys : keys;
    unsigned char* tocc = staged ? s_occ : occupied;
    int* claim = staged ? s_claim : g_rep + 5 * b;
    const int cap = R <= kRepsSmem ? kRepsSmem : static_cast<int>(b);
    int* rep_row = R <= kRepsSmem ? smem : g_rep;
    int* rep_h0 = rep_row + cap;
    int* rep_cell = rep_h0 + cap;
    int* rep_slot = rep_cell + cap;
    int* rep_key = rep_slot + cap;  // the key's first column
    if (staged) {
      for (int i = threadIdx.x; i < n * w; i += blockDim.x) s_keys[i] = keys[i];
      for (int i = threadIdx.x; i < n; i += blockDim.x) s_occ[i] = occupied[i];
    }
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      const int slot = __ldcg(fresh + k);
      const int r = row_of(__ldcg(hash + slot));
      const int* key = kmat + static_cast<long long>(r) * w;
      rep_row[k] = r;
      rep_h0[k] = static_cast<int>(hash_row(key, w) % static_cast<unsigned>(n));
      rep_cell[k] = -1;
      rep_slot[k] = slot;
      rep_key[k] = w > 0 ? key[0] : 0;
    }
    if (threadIdx.x == 0) {
      s_free = 0;
      s_skip = n;
      s_hit[0] = s_hit[1] = 0;
    }
    __syncthreads();
    int f = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      claim[i] = kNoClaim;
      f += !tocc[i];
    }
    if (f) atomicAdd(&s_free, f);
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      if (!tocc[rep_h0[k]] || own_key(tkeys, rep_h0[k], w, rep_key[k], kmat, rep_row[k])) s_hit[0] = 1;  // round 0 changes the table
    }
    __syncthreads();

    // the rounds, while a representative is unresolved and a slot is empty
    int j = 0;
    while (j < n && s_free > 0) {
      if (!s_hit[j & 1]) {
        // no unresolved representative probes an empty slot (or its own key, which never
        // happens) in this round, so it changes nothing, nor do the rounds after it until
        // one does: skip them (s_skip starts at n - j)
        volatile int* skip = &s_skip;
        for (int k = threadIdx.x; k < R; k += blockDim.x) {
          if (rep_cell[k] >= 0) continue;
          int s = rep_h0[k] + j;
          if (s >= n) s -= n;
          int d = 0;
          do {
            ++d;
            if (++s == n) s = 0;
          } while (d < *skip && tocc[s] && !own_key(tkeys, s, w, rep_key[k], kmat, rep_row[k]));
          atomicMin(&s_skip, d);
        }
        __syncthreads();
        j += s_skip;
        if (j >= n) break;
      }
      for (int k = threadIdx.x; k < R; k += blockDim.x) {  // probe: land on the key, or claim the empty slot
        if (rep_cell[k] >= 0) continue;
        int s = rep_h0[k] + j;
        if (s >= n) s -= n;
        if (!tocc[s]) {
          atomicMin(&claim[s], rep_row[k]);
        } else if (own_key(tkeys, s, w, rep_key[k], kmat, rep_row[k])) {
          rep_cell[k] = s;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) s_hit[j & 1] = 0;  // read by every thread before the barrier above
      for (int k = threadIdx.x; k < R; k += blockDim.x) {  // the lowest claimant writes its key and takes the slot
        if (rep_cell[k] >= 0) continue;
        int s = rep_h0[k] + j;
        if (s >= n) s -= n;
        if (claim_of(claim, s, staged) == rep_row[k]) {
          const int* key = kmat + static_cast<long long>(rep_row[k]) * w;
          for (int i = 0; i < w; ++i) {
            keys[static_cast<long long>(s) * w + i] = key[i];
            if (staged) s_keys[static_cast<long long>(s) * w + i] = key[i];
          }
          occupied[s] = 1;
          if (staged) s_occ[s] = 1;
          rep_cell[k] = s;
          atomicSub(&s_free, 1);
        }
      }
      __syncthreads();
      int open = 0, hit = 0;
      for (int k = threadIdx.x; k < R; k += blockDim.x) {  // every claim back to none; the next round's probes
        int s = rep_h0[k] + j;
        if (s >= n) s -= n;
        if (claim_of(claim, s, staged) != kNoClaim) claim[s] = kNoClaim;
        if (rep_cell[k] >= 0) continue;
        open = 1;
        if (++s == n) s = 0;
        hit |= !tocc[s] || own_key(tkeys, s, w, rep_key[k], kmat, rep_row[k]);
      }
      ++j;
      if (hit) s_hit[j & 1] = 1;
      if (threadIdx.x == 0) s_skip = n - j;
      if (!__syncthreads_or(open)) break;
    }
    for (int k = threadIdx.x; k < R; k += blockDim.x) hcell[rep_slot[k]] = rep_cell[k];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      ctrl[0] = ctrl[1] = ctrl[5] = 0;
      ctrl[2] = R;
      ctrl[3] = min(j, n);
      __threadfence();
      atomicExch(ctrl + 4, static_cast<int>(g));  // the cells are out
    }
  } else if (block_missed) {
    if (threadIdx.x == 0) {
      while (static_cast<unsigned>(atomicAdd(ctrl + 4, 0)) != g) __nanosleep(128);
    }
    __syncthreads();
    __threadfence();
  }
  if (!block_missed) return;

  // this block's unresolved rows take their keys' cells
  int spilled = 0;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < b;
       r += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (cells[r] >= 0) continue;
    const int c = __ldcg(hcell + hash_find(kmat, w, static_cast<int>(r), hash, mask));
    cells[r] = c;
    spilled += c < 0;
  }
  if (spilled) atomicAdd(&s_spilled, spilled);
  __syncthreads();
  if (threadIdx.x == 0 && s_spilled) atomicAdd(spills, s_spilled);
}

}  // namespace

// kmat: (b, w) int32; keys: (n, w) int32; occupied: (n,) bool; spills: ()
// int32 (all three in place); cells: (b,) int32 out; ctrl: (8,) int32 and
// hash: (hash_slots,) int64, zeroed once and then kept with the table
// between calls (the kernel leaves them ready), hash_slots a power of two
// >= 2 b; scratch: b + hash_slots + 5 b + n int32, uninitialised.
extern "C" int slice_assign(const void* kmat, int w, long long b, void* keys, void* occupied, int n, void* spills,
                            void* cells, void* ctrl, void* hash, long long hash_slots, void* scratch, void* stream) {
  if (b == 0) return 0;
  const size_t table_bytes = (static_cast<size_t>(n) * w + n) * sizeof(int) + n;
  const int staged = table_bytes <= kTableSmemMax;
  const size_t smem = 5 * kRepsSmem * sizeof(int) + (staged ? table_bytes : 0);
  static LaunchCache cache[kMaxDevices] = {};
  int sms = 0;
  cudaError_t err = hist_launch::prepare(slice_assign_kernel, smem, cache, &sms);
  if (err != cudaSuccess) return err;
  const long long blocks = std::max(1LL, std::min(2LL * sms, (b + kThreadsK4 - 1) / kThreadsK4));
  slice_assign_kernel<<<static_cast<unsigned>(blocks), kThreadsK4, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kmat), w, b, static_cast<int*>(keys), static_cast<unsigned char*>(occupied), n, staged,
      static_cast<int*>(spills), static_cast<int*>(cells), static_cast<int*>(ctrl), static_cast<u64*>(hash),
      static_cast<int>(hash_slots - 1), static_cast<int*>(scratch));
  return cudaGetLastError();
}
