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
// computes every estimate first, vectorised, and passes them in. One tag
// has one estimate for the whole scan. The result is the scan's table bit
// for bit.
//
// Which steps can change the table. Two facts hold for any table: the
// minimum count never decreases (an admission replaces the minimum with
// est > minimum, a tracked update takes a max), and a tracked slot's count
// is at least the minimum.
//   (b) A step whose est <= m, where m is the table's minimum at this or
//       any earlier step, is a no-op: if the tag is tracked, its count is
//       >= the minimum >= est, so the max keeps it; if not, est does not
//       beat the minimum. This needs no precondition.
//   (a) Every occurrence of a tag after its first in the batch is a no-op,
//       given three preconditions: the tag has one estimate in the whole
//       batch, and on the table the batch starts from every count is >= 0
//       and no two live slots (count > 0) hold one key. (The scan keeps the
//       last two: an admission writes est > minimum >= 0 for a tag no live
//       slot holds.) After the first occurrence the tag is tracked with a
//       count >= est, and stays so until it is evicted as the minimum with
//       that count; from then on the minimum is >= est, so (b) holds. Or
//       the first occurrence was rejected with est <= minimum, and (b)
//       holds from there. A negative count breaks (a): a tag admitted with
//       est = 0 over a count of -1 is not live and is admitted again into
//       the next negative slot.
// Estimates from one grid are a function of the tag, cm_merge
// (countmin.py:143-147) drops later duplicates, and the scan never makes a
// negative count, so every batch and table the package makes meets all
// three; a hand-made table or estimate vector may not, and the kernel checks.
//
// Bound on the card: bytes, 8 per tag (the tag and its estimate read once)
// and the table read and written: 0.16 us for 65,536 tags at 3.35 TB/s.
// The real floor is the chain: each step that survives the filters below
// depends on the table the one before it left, so the floor is the
// survivors times the cheapest dependent step (a ballot for the tracked
// slot, the owner's write, a redux for the new minimum). On the sketch
// phase's Zipf-like batches most tags are repeats or fall under (b).
//
// Design, four launches on the caller's stream, no host read, a fixed grid
// (all capturable in a CUDA graph); scratch from the caller:
// 1. A memset clears an open-addressing table of 64-bit entries
//    (tag << 32 | index; all ones is empty), at least 2n slots.
// 2. Many blocks insert each tag with the smallest index it has: a warp's
//    lanes holding one tag (__match_any_sync) send only the lowest lane,
//    which claims a slot by atomicCAS or lowers its index by atomicMin.
// 3. Many blocks mark each index that is its tag's first (one bit per tag,
//    a word per warp by ballot) and raise a flag where an estimate differs
//    from its tag's first one.
// 4. One block of 1024 threads. Its prologue checks the flag and the table's
//    two preconditions over the k slots; where any fails, every tag is kept
//    (the unfiltered mode: the same chain over every tag). Then it walks the
//    batch in tiles of 16384 tags, each thread holding 16 in registers
//    (four int4 loads, neighbouring threads on neighbouring 16 bytes),
//    loaded while the previous tile steps. A tile keeps the tags that are first occurrences
//    with est above the minimum at the tile's start (lemmas (a) and (b)),
//    compacted in order into shared memory by a block scan. The slot
//    warps (one thread a slot, k rounded up to warps) then step through
//    the survivors, 32 at a time: a ballot over the still-pending ones
//    whose est beats the current minimum, the first of them broadcast by
//    shuffle, a ballot for its tracked slot, the owner thread's write. The
//    (minimum, slot) pair stays in registers and is reduced again
//    (__reduce_min_sync, then a ballot for the first slot) only when a step
//    wrote the minimum's slot: an admission always does, a tracked update
//    only if it raised that slot. With k <= 32 that is one warp with no
//    barrier; with more, each warp's partials go through shared memory
//    (double-buffered by parity) and a named barrier over the slot warps.
// The serial block writes keys and counts in place, and three counters into
// the scratch: the mode, the tile filters' survivors, the steps run.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "_launch.cuh"

namespace {

using hist_launch::kMaxDevices;
using hist_launch::LaunchCache;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSlots = 1024;
constexpr int kMaxWarps = kMaxSlots / 32;
constexpr int kChainThreads = 1024;  // the serial block: every slot's thread, and the tile's gather
constexpr int kRounds = 4;           // int4 loads of tags a thread gathers per tile
constexpr int kTile = kChainThreads * 4 * kRounds;
constexpr size_t kTileSmem = static_cast<size_t>(kTile) * (sizeof(unsigned) + sizeof(int));  // the survivors' tags and estimates
constexpr int kMarkThreads = 256;
constexpr unsigned long long kEmpty = ~0ULL;

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// This warp's lanes that hold the same tag as this lane (lanes past n hold a
// 33-bit key of their own and match nothing).
__device__ __forceinline__ unsigned same_tag_lanes(bool valid, unsigned tag, int lane) {
  const unsigned long long key = valid ? static_cast<unsigned long long>(tag) : (1ULL << 32) | static_cast<unsigned>(lane);
  return __match_any_sync(kFull, key);
}

// Pass 2: each distinct tag's smallest index into the table.
__global__ void __launch_bounds__(kMarkThreads) cm_first_insert_kernel(const int* __restrict__ tags, long long n,
                                                                       unsigned long long* __restrict__ table, unsigned mask,
                                                                       int* __restrict__ mixed) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) *mixed = 0;  // the next pass raises it
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long base = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32; base < n;
       base += warps * 32) {
    const long long i = base + lane;
    const bool valid = i < n;
    const unsigned tag = valid ? static_cast<unsigned>(tags[i]) : 0u;
    const unsigned peers = same_tag_lanes(valid, tag, lane);
    if (!valid || __ffs(peers) - 1 != lane) continue;  // a lower lane holds this tag, at a smaller index
    const unsigned long long entry = (static_cast<unsigned long long>(tag) << 32) | static_cast<unsigned>(i);
    unsigned h = fmix32(tag) & mask;
    for (;;) {
      unsigned long long cur = __ldcg(table + h);
      if (cur == kEmpty) {
        cur = atomicCAS(table + h, kEmpty, entry);
        if (cur == kEmpty) break;
      }
      if (static_cast<unsigned>(cur >> 32) == tag) {
        if (cur > entry) atomicMin(table + h, entry);  // the same tag in the high half: the smaller index wins
        break;
      }
      h = (h + 1) & mask;
    }
  }
}

// Pass 3: bit i of the mark is set where index i is its tag's first;
// `mixed` is raised where a tag has two estimates.
__global__ void __launch_bounds__(kMarkThreads) cm_first_mark_kernel(const int* __restrict__ tags,
                                                                     const int* __restrict__ ests, long long n,
                                                                     const unsigned long long* __restrict__ table,
                                                                     unsigned mask, unsigned* __restrict__ first,
                                                                     int* __restrict__ mixed) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long base = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32; base < n;
       base += warps * 32) {
    const long long i = base + lane;
    const bool valid = i < n;
    const unsigned tag = valid ? static_cast<unsigned>(tags[i]) : 0u;
    const unsigned peers = same_tag_lanes(valid, tag, lane);
    const int leader = __ffs(peers) - 1;
    unsigned at = static_cast<unsigned>(i);  // the tag's first index
    if (valid && leader == lane) {
      unsigned h = fmix32(tag) & mask;
      for (;;) {
        const unsigned long long cur = __ldcg(table + h);
        if (cur == kEmpty) break;  // not reached: every tag was inserted; keeping a tag is always safe
        if (static_cast<unsigned>(cur >> 32) == tag) {
          at = static_cast<unsigned>(cur);
          break;
        }
        h = (h + 1) & mask;
      }
    }
    at = __shfl_sync(kFull, at, leader);
    if (valid && ests[i] != __ldg(ests + at)) *mixed = 1;
    const unsigned word = __ballot_sync(kFull, valid && at == static_cast<unsigned>(i));
    if (lane == 0) first[base >> 5] = word;
  }
}

__device__ __forceinline__ void slot_barrier(int threads) { asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory"); }

// The table as the slot threads hold it: thread `slot` owns one slot in
// registers; the (minimum, first slot of it) pair is the same in every slot
// thread. `parity` double-buffers the per-warp partials.
struct Table {
  unsigned key;
  int cnt;
  int cur_min;
  int min_slot;
  int parity;
};

template <bool kOneWarp>
__device__ __forceinline__ void reduce_min(Table& t, int slot, int slot_warps, int (*s_cnt)[kMaxWarps],
                                           int (*s_slot)[kMaxWarps]) {
  const int lane = slot & 31, warp = slot >> 5;
  const int wmin = __reduce_min_sync(kFull, t.cnt);
  const int wslot = warp * 32 + __ffs(__ballot_sync(kFull, t.cnt == wmin)) - 1;
  if (kOneWarp) {
    t.cur_min = wmin;
    t.min_slot = wslot;
    return;
  }
  if (lane == 0) {
    s_cnt[t.parity][warp] = wmin;
    s_slot[t.parity][warp] = wslot;
  }
  slot_barrier(slot_warps * 32);
  const int c = lane < slot_warps ? s_cnt[t.parity][lane] : INT_MAX;
  const int s = lane < slot_warps ? s_slot[t.parity][lane] : INT_MAX;
  t.cur_min = __reduce_min_sync(kFull, c);
  t.min_slot = __shfl_sync(kFull, s, __ffs(__ballot_sync(kFull, c == t.cur_min)) - 1);
  t.parity ^= 1;
}

// One step of the scan for (tag, est); returns whether the minimum was reduced again.
template <bool kOneWarp>
__device__ __forceinline__ bool step(Table& t, unsigned tag, int est, int slot, bool valid, int slot_warps,
                                     int (*s_cnt)[kMaxWarps], int (*s_slot)[kMaxWarps]) {
  const int lane = slot & 31, warp = slot >> 5;
  const unsigned tracked = __ballot_sync(kFull, valid && t.key == tag && t.cnt > 0);
  int pos;
  if (kOneWarp) {
    pos = tracked ? __ffs(tracked) - 1 : INT_MAX;
  } else {
    if (lane == 0) s_cnt[t.parity][warp] = tracked ? warp * 32 + __ffs(tracked) - 1 : INT_MAX;
    slot_barrier(slot_warps * 32);
    pos = __reduce_min_sync(kFull, lane < slot_warps ? s_cnt[t.parity][lane] : INT_MAX);
    t.parity ^= 1;
  }
  bool remin;
  if (pos != INT_MAX) {  // tracked: counts[pos] = max(counts[pos], est)
    if (slot == pos && est > t.cnt) t.cnt = est;
    remin = pos == t.min_slot && est > t.cur_min;  // the minimum's slot holds the minimum
  } else {  // admitted over the first minimum, or rejected
    remin = est > t.cur_min;
    if (remin && slot == t.min_slot) {
      t.key = tag;
      t.cnt = est;
    }
  }
  if (remin) reduce_min<kOneWarp>(t, slot, slot_warps, s_cnt, s_slot);
  return remin;
}

template <bool kOneWarp>
__global__ void __launch_bounds__(kChainThreads, 1)
    cm_track_kernel(const int* __restrict__ tags, const int* __restrict__ ests, long long n,
                    const unsigned* __restrict__ first, const int* __restrict__ mixed, unsigned* __restrict__ keys,
                    int* __restrict__ counts, int k, int* __restrict__ stats) {
  extern __shared__ unsigned s_tile[];
  unsigned* s_tag = s_tile;
  int* s_est = reinterpret_cast<int*>(s_tile + kTile);
  __shared__ int s_cnt[2][kMaxWarps];
  __shared__ int s_slot[2][kMaxWarps];
  __shared__ unsigned long long s_scan[kMaxWarps];
  __shared__ int s_min;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot_warps = (k + 31) >> 5;
  const bool slot_thread = warp < slot_warps;
  const bool valid = tid < k;
  Table t{valid ? keys[tid] : 0u, valid ? counts[tid] : INT_MAX, 0, 0, 0};  // a padding lane is never the minimum

  // prologue: the preconditions of lemma (a), with the tile's buffers as scratch
  if (valid) {
    s_tag[tid] = t.key;
    s_est[tid] = t.cnt;
  }
  __syncthreads();
  bool bad = (tid == 0 && *mixed) || (valid && t.cnt < 0);
  if (valid && t.cnt > 0) {
    for (int j = 0; j < tid && !bad; ++j) bad = s_est[j] > 0 && s_tag[j] == t.key;
  }
  const bool filtered = !__syncthreads_or(bad);
  if (slot_thread) {
    reduce_min<kOneWarp>(t, tid, slot_warps, s_cnt, s_slot);
    if (tid == 0) s_min = t.cur_min;
  }

  // a tile is kRounds rounds of kChainThreads x 4 tags: thread tid holds, in
  // round q, the four tags from tile_base + 4 * (tid + kChainThreads * q),
  // read as one int4 each (neighbouring threads on neighbouring 16 bytes)
  int4 r_tag[kRounds], r_est[kRounds];
  unsigned r_first[kRounds];
  const auto load = [&](long long tile_base) {
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const long long i = tile_base + 4LL * (tid + kChainThreads * q);
      if (i + 3 < n) {
        r_tag[q] = __ldg(reinterpret_cast<const int4*>(tags + i));
        r_est[q] = __ldg(reinterpret_cast<const int4*>(ests + i));
      } else {
        r_tag[q] = make_int4(i < n ? tags[i] : 0, i + 1 < n ? tags[i + 1] : 0, i + 2 < n ? tags[i + 2] : 0, 0);
        r_est[q] = make_int4(i < n ? ests[i] : 0, i + 1 < n ? ests[i + 1] : 0, i + 2 < n ? ests[i + 2] : 0, 0);
      }
      r_first[q] = i < n ? first[i >> 5] : 0u;
    }
  };
  load(0);
  long long survivors = 0, steps = 0;
  __syncthreads();
  for (long long tile_base = 0; tile_base < n; tile_base += kTile) {
    // gather: the tile's survivors, in order, into shared memory; a thread's
    // kept counts of its kRounds rounds go through one block scan, packed in
    // 16-bit fields of a 64-bit word
    const int m = s_min;
    int keep[kRounds];
    unsigned long long mine = 0;
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const long long i = tile_base + 4LL * (tid + kChainThreads * q);
      const int e[4] = {r_est[q].x, r_est[q].y, r_est[q].z, r_est[q].w};
      keep[q] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool is_first = (r_first[q] >> ((i + j) & 31)) & 1u;
        if (i + j < n && (!filtered || (is_first && e[j] > m))) keep[q] |= 1 << j;
      }
      mine |= static_cast<unsigned long long>(__popc(keep[q])) << (16 * q);
    }
    unsigned long long incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = s_scan[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long u = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += u;
      }
      s_scan[lane] = v;
    }
    __syncthreads();
    const unsigned long long before = (warp ? s_scan[warp - 1] : 0ULL) + incl - mine;
    const unsigned long long totals = s_scan[kMaxWarps - 1];
    int round_base = 0;
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      int at = round_base + static_cast<int>((before >> (16 * q)) & 0xFFFFu);
      const unsigned tg[4] = {static_cast<unsigned>(r_tag[q].x), static_cast<unsigned>(r_tag[q].y),
                              static_cast<unsigned>(r_tag[q].z), static_cast<unsigned>(r_tag[q].w)};
      const int e[4] = {r_est[q].x, r_est[q].y, r_est[q].z, r_est[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (keep[q] & (1 << j)) {
          s_tag[at] = tg[j];
          s_est[at] = e[j];
          ++at;
        }
      }
      round_base += static_cast<int>((totals >> (16 * q)) & 0xFFFFu);
    }
    const int kept = round_base;
    __syncthreads();
    load(tile_base + kTile);  // the next tile's loads fly while the slot warps step

    // the chain over the survivors
    if (slot_thread) {
      for (int g = 0; g < kept; g += 32) {
        const bool in = g + lane < kept;
        const unsigned tag_l = in ? s_tag[g + lane] : 0u;
        const int est_l = in ? s_est[g + lane] : 0;
        unsigned pending = __ballot_sync(kFull, in && (!filtered || est_l > t.cur_min));
        // the smallest pending estimate: while the minimum stays below it, no pending tag falls under (b)
        int lowest = filtered ? __reduce_min_sync(kFull, (pending >> lane) & 1u ? est_l : INT_MAX) : INT_MAX;
        while (pending) {
          const int j = __ffs(pending) - 1;
          pending &= pending - 1;
          const unsigned tag = __shfl_sync(kFull, tag_l, j);
          const int est = __shfl_sync(kFull, est_l, j);
          ++steps;
          if (step<kOneWarp>(t, tag, est, tid, valid, slot_warps, s_cnt, s_slot) && filtered && t.cur_min >= lowest) {
            pending &= __ballot_sync(kFull, est_l > t.cur_min);  // lemma (b) against the new minimum
            lowest = __reduce_min_sync(kFull, (pending >> lane) & 1u ? est_l : INT_MAX);
          }
        }
      }
      if (tid == 0) s_min = t.cur_min;
    }
    survivors += kept;
    __syncthreads();
  }
  if (valid) {
    keys[tid] = t.key;
    counts[tid] = t.cnt;
  }
  if (tid == 0 && stats != nullptr) {
    stats[0] = filtered ? 1 : 0;
    stats[1] = static_cast<int>(survivors);
    stats[2] = static_cast<int>(steps);
  }
}

}  // namespace

// tags, ests: (n,) int32, 16-byte aligned; keys (k,) uint32 and counts (k,) int32, updated in
// place; scratch: `slots` (a power of two >= 2n) 64-bit table entries, then
// ceil(n / 32) 32-bit first-occurrence words, then 4 int32: the mode,
// survivors and steps, and a flag for a tag with two estimates; all written
// here. Needs n < 2^31.
extern "C" int cm_track(const void* tags, const void* ests, long long n, void* keys, void* counts, int k, void* scratch,
                        long long slots, void* stream) {
  if (n == 0) return 0;
  if (k < 1 || k > kMaxSlots || n >= (1LL << 31) || slots < 2 * n || (slots & (slots - 1)) != 0 || slots > (1LL << 32) ||
      reinterpret_cast<uintptr_t>(tags) % 16 != 0 || reinterpret_cast<uintptr_t>(ests) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto stream_ = static_cast<cudaStream_t>(stream);
  const auto* tags_ = static_cast<const int*>(tags);
  const auto* ests_ = static_cast<const int*>(ests);
  auto* keys_ = static_cast<unsigned*>(keys);
  auto* counts_ = static_cast<int*>(counts);
  auto* table = static_cast<unsigned long long*>(scratch);
  auto* first = reinterpret_cast<unsigned*>(table + slots);
  auto* stats = reinterpret_cast<int*>(first + (n + 31) / 32);
  int* mixed = stats + 3;
  const auto mask = static_cast<unsigned>(slots - 1);

  auto chain = k <= 32 ? cm_track_kernel<true> : cm_track_kernel<false>;
  static LaunchCache cache[2][kMaxDevices] = {};
  int sms = 0;
  cudaError_t err = hist_launch::prepare(chain, kTileSmem, cache[k <= 32 ? 0 : 1], &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(table, 0xFF, static_cast<size_t>(slots) * sizeof(unsigned long long), stream_)) != cudaSuccess)
    return static_cast<int>(err);
  const long long warps_needed = (n + 31) / 32;
  const long long blocks = std::min<long long>(8LL * sms, (warps_needed + kMarkThreads / 32 - 1) / (kMarkThreads / 32));
  cm_first_insert_kernel<<<static_cast<unsigned>(blocks), kMarkThreads, 0, stream_>>>(tags_, n, table, mask, mixed);
  cm_first_mark_kernel<<<static_cast<unsigned>(blocks), kMarkThreads, 0, stream_>>>(tags_, ests_, n, table, mask, first, mixed);
  chain<<<1, kChainThreads, kTileSmem, stream_>>>(tags_, ests_, n, first, mixed, keys_, counts_, k, stats);
  return static_cast<int>(cudaGetLastError());
}
