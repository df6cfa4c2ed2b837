// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// cm_track: the Count-Min sketch's heavy-hitter table after a batch of tags,
// by hand for Hopper (sm_90a).
//
// Replaces: torchmetrics_tpu/sketch/countmin.py::cm_update, its lax.scan of
//   `track` over every tag of the batch. It is not a Pallas kernel (the JAX
//   package has none): the scan ported as plain PyTorch is some ten launches
//   per tag, about 650k launches per 65,536-tag update.
//
// Computes, for the tags in order, exactly the scan's step on the table
// (keys: k uint32 tags, counts: k int32 estimates, 0 = an empty slot):
//   tracked = (keys == tag) & (counts > 0)
//   pos_min = the first slot of the minimum count (jnp.argmin)
//   pos     = the first tracked slot (jnp.argmax of tracked) if any, else pos_min
//   admit   = any tracked, or est > counts[pos_min]
//   new     = max(counts[pos], est) if tracked, else est
//   if admit: keys[pos] = tag, counts[pos] = new
// `est` is each tag's Count-Min estimate against the grid after the whole
// batch was added; that grid does not change during the scan, so the caller
// computes every estimate first, vectorised, and passes them in. The result
// is the scan's table bit for bit.
//
// Bound on the card: the chain, not bytes. Each tag is read once with its
// estimate (8 bytes: 0.16 us for 65,536 tags at 3.35 TB/s), but every step
// depends on the table the step before it left, so the n steps run one
// after another.
//
// Design: one block, one thread per slot (k <= 1024; the block is k rounded
// up to whole warps), each slot's key and count kept in its thread's
// registers. A warp loads 32 tags and estimates at a time, coalesced, and
// hands them out by shuffle. Per tag, a warp finds its first tracked slot by
// ballot and its first minimum by a shuffle reduction of (count, slot)
// pairs. With one warp (k <= 32, the default k = 32) that is the whole
// decision, with no barrier; with more, each warp's lane 0 writes its two
// partials to shared memory (double-buffered by the tag's parity), one
// __syncthreads, and every warp reduces the partials itself. The slot's
// owner thread then applies the write. Launches on the caller's stream,
// allocates nothing and updates keys and counts in place; returns the
// launch's error.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSlots = 1024;
constexpr int kMaxWarps = kMaxSlots / 32;

// (count, slot) with the smaller count, and the smaller slot on a tie.
__device__ __forceinline__ void min_pair(int& cnt, int& slot, int other_cnt, int other_slot) {
  if (other_cnt < cnt || (other_cnt == cnt && other_slot < slot)) {
    cnt = other_cnt;
    slot = other_slot;
  }
}

__device__ __forceinline__ void warp_min_pair(int& cnt, int& slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(kFull, cnt, off);
    const int os = __shfl_xor_sync(kFull, slot, off);
    min_pair(cnt, slot, oc, os);
  }
}

template <bool kOneWarp>
__global__ void cm_track_kernel(const int* __restrict__ tags, const int* __restrict__ ests, long long n,
                                unsigned* __restrict__ keys, int* __restrict__ counts, int k) {
  __shared__ int s_tracked[2][kMaxWarps];  // each warp's first tracked slot, or INT_MAX
  __shared__ int s_min_cnt[2][kMaxWarps];
  __shared__ int s_min_slot[2][kMaxWarps];

  const int slot = threadIdx.x;
  const int lane = slot & 31;
  const int warp = slot >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool valid = slot < k;
  unsigned key = valid ? keys[slot] : 0u;
  int cnt = valid ? counts[slot] : INT_MAX;  // a padding lane is never the minimum

  for (long long base = 0; base < n; base += 32) {
    const long long mine = base + lane;
    const unsigned tag_l = mine < n ? static_cast<unsigned>(tags[mine]) : 0u;
    const int est_l = mine < n ? ests[mine] : 0;
    const int steps = static_cast<int>(n - base < 32 ? n - base : 32);
    for (int j = 0; j < steps; ++j) {
      const unsigned tag = __shfl_sync(kFull, tag_l, j);
      const int est = __shfl_sync(kFull, est_l, j);
      const bool tracked = valid && key == tag && cnt > 0;
      const unsigned ballot = __ballot_sync(kFull, tracked);
      int first_tracked = ballot ? warp * 32 + __ffs(ballot) - 1 : INT_MAX;
      int min_cnt = cnt;
      int min_slot = slot;
      warp_min_pair(min_cnt, min_slot);
      if (!kOneWarp) {
        const int buf = j & 1;
        if (lane == 0) {
          s_tracked[buf][warp] = first_tracked;
          s_min_cnt[buf][warp] = min_cnt;
          s_min_slot[buf][warp] = min_slot;
        }
        __syncthreads();
        int t = lane < nwarps ? s_tracked[buf][lane] : INT_MAX;
        min_cnt = lane < nwarps ? s_min_cnt[buf][lane] : INT_MAX;
        min_slot = lane < nwarps ? s_min_slot[buf][lane] : INT_MAX;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t = min(t, __shfl_xor_sync(kFull, t, off));
        warp_min_pair(min_cnt, min_slot);
        first_tracked = t;
      }
      const bool any_tracked = first_tracked != INT_MAX;
      const int pos = any_tracked ? first_tracked : min_slot;
      if (slot == pos && (any_tracked || est > min_cnt)) {
        // a tracked slot is this thread's own count; an untracked one takes est
        cnt = any_tracked ? max(cnt, est) : est;
        key = tag;
      }
    }
  }
  if (valid) {
    keys[slot] = key;
    counts[slot] = cnt;
  }
}

}  // namespace

extern "C" int cm_track(const void* tags, const void* ests, long long n, void* keys, void* counts, int k, void* stream) {
  if (n == 0) return 0;
  if (k < 1 || k > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;
  auto stream_ = static_cast<cudaStream_t>(stream);
  const auto* tags_ = static_cast<const int*>(tags);
  const auto* ests_ = static_cast<const int*>(ests);
  auto* keys_ = static_cast<unsigned*>(keys);
  auto* counts_ = static_cast<int*>(counts);
  if (threads == 32) {
    cm_track_kernel<true><<<1, threads, 0, stream_>>>(tags_, ests_, n, keys_, counts_, k);
  } else {
    cm_track_kernel<false><<<1, threads, 0, stream_>>>(tags_, ests_, n, keys_, counts_, k);
  }
  return static_cast<int>(cudaGetLastError());
}
