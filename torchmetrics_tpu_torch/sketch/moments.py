# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Chan/Welford parallel-merge running moments, count / mean / M2
(counterpart of ``torchmetrics_tpu/sketch/moments.py``).

The numerically stable streaming mean and variance state, with Chan et
al.'s pairwise combine as the merge. Works elementwise over any state shape
(scalars, per-class vectors, images). The count is int32, exact to
``2**31 - 1`` (a float32 count would stall at ``2**24``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from torchmetrics_tpu_torch.sketch.registry import register_sketch_state
from torchmetrics_tpu_torch.utilities.data import _to_tensor, resolve_device

Tensor = torch.Tensor


class MomentsSketch(NamedTuple):
    """Registered state of the running moments."""

    count: Tensor  #: () int32 number of points folded in
    mean: Tensor  #: (shape) running mean
    m2: Tensor  #: (shape) running sum of squared deviations


def moments_init(
    shape: Tuple[int, ...] = (), dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
) -> MomentsSketch:
    """Empty moments accumulator over values of ``shape``, on ``device``."""
    device = resolve_device(device, "moments_init")
    return MomentsSketch(
        count=torch.tensor(0, dtype=torch.int32, device=device),
        mean=torch.zeros(shape, dtype=dtype, device=device),
        m2=torch.zeros(shape, dtype=dtype, device=device),
    )


def moments_merge(a: MomentsSketch, b: MomentsSketch) -> MomentsSketch:
    """Chan et al. parallel combine: shape-preserving, exact in count and
    stable in mean and M2 (no catastrophic cancellation)."""
    if a.mean.shape != b.mean.shape:
        raise ValueError(f"cannot merge moments over different shapes: {tuple(a.mean.shape)} vs {tuple(b.mean.shape)}")
    dtype = a.mean.dtype
    n = a.count + b.count
    an, bn = a.count.to(dtype), b.count.to(dtype)
    safe_n = torch.clamp(n, min=1).to(dtype)
    delta = b.mean - a.mean
    mean = a.mean + delta * (bn / safe_n)
    m2 = a.m2 + b.m2 + torch.square(delta) * (an * bn / safe_n)
    return MomentsSketch(count=n, mean=mean, m2=m2)


def moments_update(state: MomentsSketch, x: Union[Tensor, object]) -> MomentsSketch:
    """Fold a batch (leading axis = batch) in through a batch mean and M2 and
    the Chan merge."""
    x = _to_tensor(x, state.mean.device).to(state.mean.dtype)
    if x.ndim == state.mean.ndim:  # a single observation
        x = x[None]
    if x.shape[0] == 0:
        return state
    n_b = torch.full((), x.shape[0], dtype=torch.int32, device=x.device)
    mean_b = torch.mean(x, dim=0)
    m2_b = torch.sum(torch.square(x - mean_b), dim=0)
    return moments_merge(state, MomentsSketch(count=n_b, mean=mean_b, m2=m2_b))


def moments_mean(state: MomentsSketch) -> Tensor:
    """Running mean (NaN when empty)."""
    return torch.where(state.count > 0, state.mean, float("nan"))


def moments_variance(state: MomentsSketch, ddof: int = 0) -> Tensor:
    """Running variance with ``ddof`` degrees-of-freedom correction."""
    denom = (state.count - ddof).to(state.m2.dtype)
    return torch.where(denom > 0, state.m2 / torch.where(denom > 0, denom, 1.0), float("nan"))


def moments_std(state: MomentsSketch, ddof: int = 0) -> Tensor:
    return torch.sqrt(moments_variance(state, ddof))


def moments_count(state: MomentsSketch) -> Tensor:
    return state.count


register_sketch_state(MomentsSketch, moments_merge)
