# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Count-Min sketch with a SpaceSaving-style heavy-hitter track (counterpart
of ``torchmetrics_tpu/sketch/countmin.py``).

A ``[depth, width]`` int32 counter grid where every item increments one cell
per row (row-seeded murmur hashes) and a point query takes the **min** over
rows: always an upper bound on the true count, and at most
``true + (e/width) * N`` with probability ``1 - e^-depth`` (Cormode &
Muthukrishnan 2005). The grid merge is exact elementwise addition.

A fixed-``k`` candidate table rides along: the minimum-estimate candidate is
evicted when a larger newcomer arrives, with estimates scored against the
grid after the batch. That table update is a dependent scan over the batch's
tags; it runs as the hand kernel K3 on the card
(:func:`~torchmetrics_tpu_torch.ops.cm_track.cm_track`), after every tag's
estimate is computed at once. Merge re-scores the union of both tables
against the merged grid and keeps the top ``k`` with a deterministic
(count desc, key asc) tie-break.

Items are opaque 32-bit tags exactly as in
:mod:`torchmetrics_tpu_torch.sketch.hll`, hashed in int64; the table's keys
are stored as ``uint32``, the JAX package's dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from torchmetrics_tpu_torch.ops.cm_track import cm_track
from torchmetrics_tpu_torch.sketch.hll import _fmix32, _mul32, _tags_of
from torchmetrics_tpu_torch.sketch.registry import register_sketch_state
from torchmetrics_tpu_torch.utilities.data import resolve_device

Tensor = torch.Tensor


class CountMinSketch(NamedTuple):
    """Registered state of the Count-Min + heavy-hitter sketch."""

    counts: Tensor  #: (depth, width) int32 counter grid
    hh_keys: Tensor  #: (k,) uint32 heavy-hitter candidate tags
    hh_counts: Tensor  #: (k,) int32 candidate count estimates (0 = empty slot)
    count: Tensor  #: () int32 total items folded in


def _row_seeds(depth: int, device: torch.device) -> Tensor:
    """Deterministic per-row hash seeds, a pure function of the row index, so
    any two sketches of one depth hash identically and merge exactly."""
    rows = torch.arange(1, depth + 1, dtype=torch.int64, device=device)
    return _fmix32(_mul32(rows, 0x9E3779B9))


def _columns(tags: Tensor, depth: int, width: int) -> Tensor:
    """(depth, n) column index per row for each tag (int64 tags in [0, 2**32))."""
    seeds = _row_seeds(depth, tags.device)
    return _fmix32(tags[None, :] ^ seeds[:, None]) % width


def cm_init(depth: int = 4, width: int = 1024, k: int = 32, device: Union[str, torch.device] = "cuda") -> CountMinSketch:
    """Empty Count-Min grid with a ``k``-slot heavy-hitter table on ``device``.

    Defaults give an overestimate ``<= e/1024 * N ~ 0.27% of N`` per query
    with probability ``1 - e^-4 ~ 98%`` in 16 KiB of grid state.
    """
    if depth < 1:
        raise ValueError(f"need depth >= 1, got {depth}")
    if width < 2:
        raise ValueError(f"need width >= 2, got {width}")
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    device = resolve_device(device, "cm_init")
    return CountMinSketch(
        counts=torch.zeros((depth, width), dtype=torch.int32, device=device),
        hh_keys=torch.zeros((k,), dtype=torch.int64, device=device).to(torch.uint32),
        hh_counts=torch.zeros((k,), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _point(counts: Tensor, tags: Tensor) -> Tensor:
    """Min-over-rows count estimate for each tag (the Count-Min upper bound)."""
    depth, width = counts.shape
    cols = _columns(tags, depth, width)
    return torch.gather(counts, 1, cols).amin(dim=0)


def _int32_bits(tags: Tensor) -> Tensor:
    """int64 tags in [0, 2**32) as int32 tensors of the same 32 bits."""
    return torch.where(tags >= 2**31, tags - 2**32, tags).to(torch.int32)


def cm_update(state: CountMinSketch, x: Union[Tensor, object]) -> CountMinSketch:
    """Fold a batch of tags in (shapes preserved).

    The grid takes one scatter-add; every tag's estimate against the new grid
    is then computed at once, and the heavy-hitter table is scanned over the
    tags in order by :func:`~torchmetrics_tpu_torch.ops.cm_track.cm_track`.
    """
    tags = _tags_of(x, state.counts.device)
    if tags.numel() == 0:
        return state
    depth, width = state.counts.shape
    cols = _columns(tags, depth, width)
    flat = (cols + width * torch.arange(depth, device=tags.device)[:, None]).reshape(-1)
    counts = state.counts.reshape(-1).index_add(
        0, flat, torch.ones((), dtype=torch.int32, device=tags.device).expand(flat.numel())
    ).reshape(depth, width)
    hh_keys, hh_counts = cm_track(_int32_bits(tags), _point(counts, tags), state.hh_keys, state.hh_counts)
    return CountMinSketch(counts=counts, hh_keys=hh_keys, hh_counts=hh_counts, count=state.count + tags.numel())


def _top_k(keys: Tensor, ests: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Deterministic top-``k`` by (count desc, key asc), ``jnp.lexsort((keys,
    -ests))``: a stable sort by key, then a stable sort by ``-est``. Keys are
    ordered as unsigned 32-bit values (sorted and gathered in int64; the
    result is ``uint32``)."""
    keys = keys.to(torch.int64)
    by_key = torch.argsort(keys, stable=True)
    order = by_key[torch.argsort(-ests[by_key], stable=True)][:k]
    return keys[order].to(torch.uint32), ests[order]


def cm_merge(a: CountMinSketch, b: CountMinSketch) -> CountMinSketch:
    """Merge: grid counts add exactly (one geometry hashes identically); the
    heavy-hitter union is re-scored against the merged grid and the top ``k``
    kept with a deterministic tie-break."""
    if a.counts.shape != b.counts.shape or a.hh_keys.shape != b.hh_keys.shape:
        raise ValueError(
            "cannot merge Count-Min sketches of different geometry:"
            f" {tuple(a.counts.shape)}+{tuple(a.hh_keys.shape)} vs {tuple(b.counts.shape)}+{tuple(b.hh_keys.shape)}"
        )
    counts = a.counts + b.counts
    cand = torch.cat([a.hh_keys.to(torch.int64), b.hh_keys.to(torch.int64)])
    valid = torch.cat([a.hh_counts > 0, b.hh_counts > 0])
    ests = torch.where(valid, _point(counts, cand), 0)
    # drop later duplicates of the same key so one item can't hold two slots
    same = (cand[None, :] == cand[:, None]) & valid[:, None] & valid[None, :]
    dup_of_earlier = torch.any(torch.tril(same, -1), dim=1)
    ests = torch.where(dup_of_earlier, 0, ests)
    hh_keys, hh_counts = _top_k(cand, ests, a.hh_keys.shape[0])
    return CountMinSketch(counts=counts, hh_keys=hh_keys, hh_counts=hh_counts, count=a.count + b.count)


def cm_point_query(state: CountMinSketch, x: Union[Tensor, object]) -> Tensor:
    """Estimated count(s) for tag(s) ``x``, never below the true count."""
    return _point(state.counts, _tags_of(x, state.counts.device))


def cm_heavy_hitters(state: CountMinSketch) -> Tuple[Tensor, Tensor]:
    """``(keys, counts)`` candidate table sorted by (count desc, key asc);
    slots with count 0 are empty."""
    return _top_k(state.hh_keys, state.hh_counts, state.hh_keys.shape[0])


def cm_error_bound(state: CountMinSketch) -> float:
    """Additive overestimate bound ``(e/width) * N`` that holds per point
    query with probability ``1 - e^-depth`` (host-side; reads ``count``)."""
    depth, width = state.counts.shape
    return math.e / width * int(state.count)


def cm_state_bytes(depth: int = 4, width: int = 1024, k: int = 32) -> int:
    """Fixed state footprint in bytes for a given geometry."""
    return depth * width * 4 + k * 8 + 4


register_sketch_state(CountMinSketch, cm_merge)
