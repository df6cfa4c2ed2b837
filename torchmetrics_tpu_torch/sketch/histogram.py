# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Fixed-bin streaming histogram (counterpart of
``torchmetrics_tpu/sketch/histogram.py``), the simplest mergeable sketch.

Bin edges are fixed at ``init``, so the state is a count vector plus
out-of-range tallies and merging is elementwise addition: exactly
associative and commutative. The edges are ``jnp.linspace``'s float32 grid
bit for bit (:func:`~torchmetrics_tpu_torch.utilities.compute._linspace_like_jax`;
``torch.linspace`` differs in the last bit at some points), and the counts
go through the capture-safe scatter-add of ``utilities.data._bincount``, so
the update reads nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from torchmetrics_tpu_torch.sketch.registry import register_sketch_state
from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax
from torchmetrics_tpu_torch.utilities.data import _bincount, _to_tensor, resolve_device

Tensor = torch.Tensor


class HistogramSketch(NamedTuple):
    """Registered state of the fixed-bin histogram."""

    edges: Tensor  #: (bins+1,) monotonically increasing bin edges (constant)
    counts: Tensor  #: (bins,) int32 in-range counts
    low: Tensor  #: () int32 count of values < edges[0]
    high: Tensor  #: () int32 count of values > edges[-1]
    count: Tensor  #: () int32 total values folded in


def _int32(value: int, device: torch.device) -> Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def hist_init(
    bins: int, lo: float, hi: float, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
) -> HistogramSketch:
    """Empty histogram of ``bins`` equal-width bins over ``[lo, hi]``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    if bins < 1:
        raise ValueError(f"need bins >= 1, got {bins}")
    if not lo < hi:
        raise ValueError(f"need lo < hi, got ({lo}, {hi})")
    device = resolve_device(device, "hist_init")
    if dtype == torch.float32:
        edges = _linspace_like_jax(lo, hi, bins + 1, device=device)
    else:
        edges = torch.linspace(lo, hi, bins + 1, dtype=dtype, device=device)
    return HistogramSketch(
        edges=edges,
        counts=torch.zeros((bins,), dtype=torch.int32, device=device),
        low=_int32(0, device),
        high=_int32(0, device),
        count=_int32(0, device),
    )


def hist_update(state: HistogramSketch, x: Union[Tensor, object]) -> HistogramSketch:
    """Fold a batch in (a scatter-add; shapes preserved)."""
    edges = state.edges
    x = _to_tensor(x, edges.device).reshape(-1).to(edges.dtype)
    if x.numel() == 0:
        return state
    bins = state.counts.shape[0]
    below = (x < edges[0]).sum(dtype=torch.int32)
    above = (x > edges[-1]).sum(dtype=torch.int32)
    idx = (torch.searchsorted(edges, x, right=True) - 1).clamp(0, bins - 1)
    in_range = (x >= edges[0]) & (x <= edges[-1])
    # out-of-range values go to the trash bin ``bins`` that _bincount slices away
    counts = state.counts + _bincount(torch.where(in_range, idx, bins), bins)
    return HistogramSketch(
        edges=edges,
        counts=counts,
        low=state.low + below,
        high=state.high + above,
        count=state.count + x.numel(),
    )


def hist_merge(a: HistogramSketch, b: HistogramSketch) -> HistogramSketch:
    """Exact merge: counts add. Both sketches must share the edge vector
    (same shape is enforced here; same values are the caller's init contract)."""
    if a.edges.shape != b.edges.shape:
        raise ValueError(f"cannot merge histograms with different bin counts: {tuple(a.edges.shape)} vs {tuple(b.edges.shape)}")
    return HistogramSketch(
        edges=a.edges,
        counts=a.counts + b.counts,
        low=a.low + b.low,
        high=a.high + b.high,
        count=a.count + b.count,
    )


def hist_counts(state: HistogramSketch) -> Tuple[Tensor, Tensor, Tensor]:
    """``(counts, low, high)``: in-range per-bin counts plus out-of-range tallies."""
    return state.counts, state.low, state.high


def hist_cdf(state: HistogramSketch, v: Union[float, Tensor]) -> Tensor:
    """Approximate CDF at ``v`` (linear interpolation within a bin)."""
    edges = state.edges
    dtype = edges.dtype
    v = torch.as_tensor(v, dtype=dtype, device=edges.device)
    cum = torch.cumsum(state.counts, 0, dtype=torch.int32).to(dtype)
    padded = torch.cat([torch.zeros((1,), dtype=dtype, device=edges.device), cum])
    bins = state.counts.shape[0]
    pos = (torch.searchsorted(edges, v.reshape(-1), right=True) - 1).clamp(0, bins - 1).reshape(v.shape)
    width = edges[pos + 1] - edges[pos]
    frac = ((v - edges[pos]) / torch.where(width > 0, width, 1.0)).clamp(0.0, 1.0)
    below = state.low.to(dtype) + padded[pos] + frac * state.counts[pos].to(dtype)
    below = torch.where(v < edges[0], 0.0, below)
    below = torch.where(v >= edges[-1], state.count.to(dtype) - state.high.to(dtype), below)
    return below / torch.clamp(state.count, min=1).to(dtype)


def hist_quantile(state: HistogramSketch, q: Union[float, Tensor]) -> Tensor:
    """Approximate ``q``-quantile from the binned CDF (interpolated; clamps
    to the histogram range; NaN on an empty sketch)."""
    edges = state.edges
    dtype = edges.dtype
    q = torch.as_tensor(q, dtype=dtype, device=edges.device)
    total = state.count.to(dtype)
    cum = state.low.to(dtype) + torch.cumsum(state.counts, 0, dtype=torch.int32).to(dtype)
    padded = torch.cat([state.low.to(dtype).reshape(1), cum])
    target = torch.minimum(torch.clamp(q * total, min=0.0), total)
    bins = state.counts.shape[0]
    pos = (torch.searchsorted(padded, target.reshape(-1), right=False) - 1).clamp(0, bins - 1).reshape(target.shape)
    binc = state.counts[pos].to(dtype)
    frac = ((target - padded[pos]) / torch.where(binc > 0, binc, 1.0)).clamp(0.0, 1.0)
    out = edges[pos] + frac * (edges[pos + 1] - edges[pos])
    return torch.where(state.count > 0, out, torch.tensor(float("nan"), dtype=dtype, device=edges.device))


register_sketch_state(HistogramSketch, hist_merge)
