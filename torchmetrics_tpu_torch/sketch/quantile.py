# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""KLL-style streaming quantile sketch, the deterministic-compaction variant
(counterpart of ``torchmetrics_tpu/sketch/quantile.py``; Karnin, Lang &
Liberty, 2016).

Fixed-shape and mergeable: the state is ``(levels, capacity)`` tensors whose
shapes never change, so update and merge run inside a captured step like any
elementwise state.

- level ``l`` holds up to ``capacity`` items, each standing for ``2**l``
  original points;
- inserting a batch builds a throwaway sketch of the batch (its compaction
  cascade is fixed by the batch's size alone) and merges it in;
- a level over capacity *compacts*: items are sorted and the odd-position
  half is promoted to level ``l+1`` at double weight, the even half
  dropped (plus one kept leftover when the count is odd).

One compaction at level ``l`` moves the rank of any query point by at most
``2**l``; the state counts compactions per level, so :func:`kll_error_bound`
is a hard bound ``sum_l compactions[l] * 2**l`` on every query's rank error.
Total weight is conserved by compaction, so ``count`` is exact.

The arithmetic is the JAX package's step for step, so states and queries
are bitwise equal to its on the same input. Sorts are stable
(``torch.sort(stable=True)``, ``torch.argsort(stable=True)``: torch's default
argsort is not) and cumulative weights are int32, as JAX keeps them.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple, Union

import torch

from torchmetrics_tpu_torch.sketch.registry import register_sketch_state
from torchmetrics_tpu_torch.utilities.data import _to_tensor, resolve_device

Tensor = torch.Tensor

#: default geometry: ~0.9% worst-case rank error up to ``count = capacity *
#: 2**(levels-1)`` ≈ 1.3e8 points in ~140 KB of state (see kll_geometry)
DEFAULT_CAPACITY = 2048
DEFAULT_LEVELS = 17


class KLLSketch(NamedTuple):
    """Registered state of the quantile sketch (all leaves fixed-shape)."""

    items: Tensor  #: (levels, capacity) item values; empty slots hold +inf
    sizes: Tensor  #: (levels,) int32 number of live items per level
    compactions: Tensor  #: (levels,) int32 compactions performed per level
    count: Tensor  #: () int32 exact number of points folded in
    minimum: Tensor  #: () running exact min (+inf when empty)
    maximum: Tensor  #: () running exact max (-inf when empty)
    overflow: Tensor  #: () bool: a carry out of the top level was dropped


#: the exact-count ceiling: ``count`` is int32, so a sketch may never be
#: sized to absorb more weight than this before its overflow latch fires
MAX_STREAM = 2**31 - 1


def kll_levels_for(capacity: int, max_n: float) -> int:
    """Levels needed for a sketch of ``capacity`` to absorb ``max_n`` points
    without overflow (+1 spare level of headroom)."""
    if not 0 < max_n <= MAX_STREAM:
        raise ValueError(f"max_n must be in (0, {MAX_STREAM}] (int32-exact counts), got {max_n}")
    return max(1, int(math.ceil(math.log2(max(max_n / capacity, 1.0)))) + 1) + 1


def kll_geometry(eps: float, max_n: float = 1e8) -> Tuple[int, int]:
    """Smallest power-of-two ``(capacity, levels)`` whose deterministic
    worst-case rank error stays ≤ ``eps * n`` for streams up to ``max_n``
    (the bound is ``n * L / capacity`` with ``L = floor(log2(n / capacity)) + 1``
    compacting levels)."""
    if not 0 < eps < 1:
        raise ValueError(f"eps must be in (0, 1), got {eps}")
    if not 0 < max_n <= MAX_STREAM:
        raise ValueError(f"max_n must be in (0, {MAX_STREAM}] (int32-exact counts), got {max_n}")
    capacity = 32
    while capacity * 2 <= 2**24:
        levels_active = max(1, int(math.floor(math.log2(max(max_n / capacity, 1.0)))) + 1)
        if levels_active / capacity <= eps:
            break
        capacity *= 2
    return capacity, kll_levels_for(capacity, max_n)


def _empty(levels: int, capacity: int, dtype: torch.dtype, device: torch.device) -> KLLSketch:
    def int32(shape: Tuple[int, ...]) -> Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return KLLSketch(
        items=torch.full((levels, capacity), math.inf, dtype=dtype, device=device),
        sizes=int32((levels,)),
        compactions=int32((levels,)),
        count=int32(()),
        minimum=torch.full((), math.inf, dtype=dtype, device=device),
        maximum=torch.full((), -math.inf, dtype=dtype, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def kll_init(
    capacity: int = DEFAULT_CAPACITY,
    levels: int = DEFAULT_LEVELS,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> KLLSketch:
    """Empty sketch of the given geometry on ``device``: ``capacity`` items per
    level, ``levels`` levels; holds up to ``capacity * 2**(levels-1)`` points
    before latching ``overflow``."""
    if capacity < 2 or levels < 1:
        raise ValueError(f"need capacity >= 2 and levels >= 1, got ({capacity}, {levels})")
    if capacity * 2 ** (levels - 1) > MAX_STREAM:
        raise ValueError(
            f"geometry ({capacity}, {levels}) absorbs up to {capacity * 2 ** (levels - 1):.2e} points,"
            f" beyond the int32-exact count ceiling {MAX_STREAM}; lower `levels` (error bounds"
            " past ~2e9 points need a coarser eps anyway)"
        )
    if not dtype.is_floating_point:
        raise ValueError(f"KLLSketch requires a floating dtype (inf sentinels), got {dtype}")
    return _empty(levels, capacity, dtype, resolve_device(device, "kll_init"))


def _sketch_of_batch(x: Tensor, levels: int, capacity: int, dtype: torch.dtype) -> KLLSketch:
    """A throwaway sketch of one batch. The compaction cascade depends on the
    batch's size alone, so it unrolls on the host: nothing is read back. The
    level rows are assembled out of place, so the update also runs under
    ``torch.func.vmap`` (the sliced plan's per-row update)."""
    x = x.reshape(-1).to(dtype)
    n_in = int(x.numel())
    empty = _empty(levels, capacity, dtype, x.device)
    if n_in == 0:
        return empty
    rows, sizes, compactions = [], [0] * levels, [0] * levels

    def row(values: Tensor) -> Tensor:
        return torch.cat([values, empty.items[0, values.shape[0] :]])

    cur = torch.sort(x, stable=True).values
    level = 0
    while cur.numel() > capacity:
        if level >= levels - 1:
            raise ValueError(
                f"a single batch of {n_in} elements cannot fit a ({levels}, {capacity})"
                f" KLLSketch — raise `levels`/`capacity` (or split the batch)"
            )
        n = int(cur.numel())
        if n % 2 == 1:  # the leftover stays at this level, weight preserved
            rows.append(row(cur[n - 1 :]))
            sizes[level] = 1
        else:
            rows.append(empty.items[level])
        compactions[level] += 1
        cur = cur[1 : n - (n % 2) : 2]  # odd positions of the paired prefix
        level += 1
    rows.append(row(cur))
    sizes[level] += int(cur.numel())
    rows.extend(empty.items[level + 1 :])
    # the per-level ints come from device ops, not a host-to-device copy (a
    # CUDA graph capture of the update may hold this)
    index = torch.arange(levels, dtype=torch.int32, device=x.device)

    def ints(values: List[int]) -> Tensor:
        out = empty.sizes
        for i, v in enumerate(values):
            if v:
                out = torch.where(index == i, v, out)
        return out

    return KLLSketch(
        items=torch.stack(rows),
        sizes=ints(sizes),
        compactions=ints(compactions),
        count=torch.full((), n_in, dtype=torch.int32, device=x.device),
        minimum=torch.min(x),
        maximum=torch.max(x),
        overflow=empty.overflow,
    )


def kll_merge(a: KLLSketch, b: KLLSketch) -> KLLSketch:
    """Pairwise merge: pure and shape-preserving.

    Levelwise: combine both level buffers with the carry promoted from
    below; an over-capacity level compacts. The carry holds ≤ ``2*capacity``
    items, so every intermediate shape is fixed. A carry out of the top
    level cannot be represented and latches ``overflow``.
    """
    levels, capacity = a.items.shape
    if tuple(b.items.shape) != (levels, capacity):
        raise ValueError(
            f"cannot merge KLL sketches of different geometry: {tuple(a.items.shape)} vs {tuple(b.items.shape)}"
        )
    dtype, device = a.items.dtype, a.items.device
    carry_items = torch.full((2 * capacity,), math.inf, dtype=dtype, device=device)
    carry_n = torch.zeros((), dtype=torch.int32, device=device)
    slot0 = torch.arange(capacity, device=device) == 0
    odd_pos = 2 * torch.arange(2 * capacity, device=device) + 1
    rows, row_sizes, compacted = [], [], []
    for level in range(levels):
        combined = torch.sort(torch.cat([a.items[level], b.items[level], carry_items]), stable=True).values
        n = a.sizes[level] + b.sizes[level] + carry_n
        too_big = n > capacity
        # fits: the first n slots of the sorted 4K buffer are the live items;
        # compacts: only the odd-count leftover (the largest paired-out item) stays
        # a gather, not combined[tensor]: indexing with a 0-d tensor reads it on the host
        leftover = combined.gather(0, torch.clamp(n - 1, min=0).long().reshape(1)).reshape(())
        kept_big = torch.where(slot0 & (n % 2 == 1), leftover, math.inf)
        rows.append(torch.where(too_big, kept_big, combined[:capacity]))
        row_sizes.append(torch.where(too_big, n % 2, n))
        compacted.append(too_big)
        # odd positions 1,3,5,... of the live prefix promote at double weight
        carry_items = torch.where(too_big & (odd_pos < n), combined[1::2], math.inf)
        carry_n = torch.where(too_big, n // 2, 0)
    return KLLSketch(
        items=torch.stack(rows),
        sizes=torch.stack(row_sizes).to(torch.int32),
        compactions=a.compactions + b.compactions + torch.stack(compacted).to(torch.int32),
        count=a.count + b.count,
        minimum=torch.minimum(a.minimum, b.minimum),
        maximum=torch.maximum(a.maximum, b.maximum),
        overflow=a.overflow | b.overflow | (carry_n > 0),
    )


def kll_update(state: KLLSketch, x: Union[Tensor, object]) -> KLLSketch:
    """Fold a batch of values into the sketch (state shapes unchanged)."""
    x = _to_tensor(x, state.items.device)
    if x.numel() == 0:  # empty updates are the identity
        return state
    levels, capacity = state.items.shape
    return kll_merge(state, _sketch_of_batch(x, levels, capacity, state.items.dtype))


def _level_weights(levels: int, device: torch.device) -> Tensor:
    return torch.bitwise_left_shift(torch.ones((), dtype=torch.int32, device=device),
                                    torch.arange(levels, dtype=torch.int32, device=device))


def _weighted_items(state: KLLSketch) -> Tuple[Tensor, Tensor]:
    """All live items flattened with their integer weights (dead slots get
    weight 0; their +inf values sort to the end)."""
    levels, capacity = state.items.shape
    device = state.items.device
    values = state.items.reshape(-1)
    weights = _level_weights(levels, device)[:, None].expand(levels, capacity).reshape(-1)
    live = (torch.arange(capacity, device=device)[None, :] < state.sizes[:, None]).reshape(-1)
    return values, torch.where(live, weights, 0)


def _sorted_cdf_arrays(state: KLLSketch) -> Tuple[Tensor, Tensor]:
    values, weights = _weighted_items(state)
    order = torch.argsort(values, stable=True)
    return values[order], torch.cumsum(weights[order], 0, dtype=torch.int32)


def _searchsorted(sorted_seq: Tensor, v: Tensor, right: bool) -> Tensor:
    return torch.searchsorted(sorted_seq, v.reshape(-1).contiguous(), right=right).reshape(v.shape)


def kll_quantile(state: KLLSketch, q: Union[float, Tensor]) -> Tensor:
    """Approximate ``q``-quantile(s); scalar or vector ``q``. Exact at the
    endpoints (the sketch tracks the true min and max); NaN on an empty sketch."""
    sv, cum = _sorted_cdf_arrays(state)
    q = torch.as_tensor(q, dtype=sv.dtype, device=sv.device)
    count = state.count.to(sv.dtype)
    target = torch.minimum(torch.clamp(torch.ceil(q * count), min=1.0), torch.clamp(count, min=1.0))
    idx = _searchsorted(cum.to(sv.dtype), target, right=False).clamp(0, sv.numel() - 1)
    out = torch.minimum(torch.maximum(sv[idx], state.minimum), state.maximum)
    out = torch.where(q <= 0.0, state.minimum, torch.where(q >= 1.0, state.maximum, out))
    return torch.where(state.count > 0, out, float("nan"))


def kll_rank(state: KLLSketch, v: Union[float, Tensor]) -> Tensor:
    """Approximate number of folded points ``<= v`` (scalar or vector ``v``)."""
    sv, cum = _sorted_cdf_arrays(state)
    pos = _searchsorted(sv, torch.as_tensor(v, dtype=sv.dtype, device=sv.device), right=True)
    padded = torch.cat([torch.zeros((1,), dtype=cum.dtype, device=cum.device), cum])
    return padded[pos]


def kll_cdf(state: KLLSketch, v: Union[float, Tensor]) -> Tensor:
    """Approximate empirical CDF at ``v``: ``rank(v) / count`` (0 when empty)."""
    dtype = state.items.dtype
    return kll_rank(state, v).to(dtype) / torch.clamp(state.count, min=1).to(dtype)


def kll_error_bound(state: KLLSketch) -> Tensor:
    """Hard deterministic bound on the rank error of any query:
    ``sum_l compactions[l] * 2**l`` (+inf once ``overflow`` latched)."""
    levels = state.compactions.shape[0]
    weights = _level_weights(levels, state.compactions.device)
    bound = (state.compactions * weights).sum(dtype=torch.int32).to(torch.float32)
    return torch.where(state.overflow, math.inf, bound)


def kll_state_bytes(state: KLLSketch) -> int:
    """Total bytes of the (fixed-shape) state: the number that stays flat
    while a ``cat`` state grows with the stream."""
    return sum(leaf.numel() * leaf.element_size() for leaf in state)


register_sketch_state(KLLSketch, kll_merge)
