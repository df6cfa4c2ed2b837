# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Counter-based mergeable reservoir sample with explicit PRNG key threading
(counterpart of ``torchmetrics_tpu/sketch/reservoir.py``).

Every incoming value draws a uniform tag and the reservoir keeps the
``capacity`` values with the LARGEST tags (Efraimidis & Spirakis A-Res with
unit weights): a uniform sample without replacement, mergeable as the
top-``capacity`` of the tag union, fixed-shape throughout.

Randomness is explicit: the PRNG key lives IN the state and every update
splits it, so replaying a stream from one ``init`` seed is bit-reproducible.
The key is JAX's threefry key (:mod:`~torchmetrics_tpu_torch.sketch._threefry`
reproduces ``jax.random`` bit for bit), so a reservoir saved by either
package and resumed in the other draws the same tags.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from torchmetrics_tpu_torch.sketch import _threefry
from torchmetrics_tpu_torch.sketch.registry import register_sketch_state
from torchmetrics_tpu_torch.utilities.data import _to_tensor, resolve_device

Tensor = torch.Tensor


class ReservoirSketch(NamedTuple):
    """Registered state of the uniform reservoir sample."""

    values: Tensor  #: (capacity,) sampled values (junk beyond the filled slots)
    tags: Tensor  #: (capacity,) float32 uniform tags; -inf marks an empty slot
    count: Tensor  #: () int32 total values seen
    key: Tensor  #: (2,) uint32 threaded PRNG key (jax.random.PRNGKey layout)


def reservoir_init(
    capacity: int,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    rank: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> ReservoirSketch:
    """Empty reservoir of ``capacity`` slots on ``device``, randomness rooted
    at ``seed``.

    **Multi-rank use MUST pass a distinct ``rank``** (e.g. the process's
    rank): two reservoirs initialised from the same ``(seed, rank)`` draw
    identical tag sequences, so a merge of their samples would select the
    same stream positions on both sides. ``rank`` is folded into the key.
    """
    if capacity < 1:
        raise ValueError(f"need capacity >= 1, got {capacity}")
    device = resolve_device(device, "reservoir_init")
    key = _threefry.prng_key(seed, device)
    if rank:
        key = _threefry.fold_in(key, torch.tensor(rank, device=device))
    return ReservoirSketch(
        values=torch.zeros((capacity,), dtype=dtype, device=device),
        tags=torch.full((capacity,), -math.inf, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        key=key,
    )


def _top_capacity(values: Tensor, tags: Tensor, capacity: int) -> Tuple[Tensor, Tensor]:
    order = torch.argsort(-tags, stable=True)[:capacity]
    return values[order], tags[order]


def reservoir_update(state: ReservoirSketch, x: Union[Tensor, object]) -> ReservoirSketch:
    """Fold a batch in: draw one tag per value from the threaded key, keep the
    top-``capacity`` tagged values (shapes preserved)."""
    x = _to_tensor(x, state.values.device).reshape(-1).to(state.values.dtype)
    if x.numel() == 0:
        return state
    capacity = state.values.shape[0]
    key, sub = _threefry.split(state.key)
    tags = _threefry.uniform(sub, x.numel())
    values, tags = _top_capacity(torch.cat([state.values, x]), torch.cat([state.tags, tags]), capacity)
    return ReservoirSketch(values, tags, state.count + x.numel(), key)


def reservoir_merge(a: ReservoirSketch, b: ReservoirSketch) -> ReservoirSketch:
    """Top-``capacity`` of the tag union, exact on the sample; the threaded
    key folds the peer's count in so later updates stay decorrelated."""
    if a.values.shape != b.values.shape:
        raise ValueError(f"cannot merge reservoirs of different capacity: {tuple(a.values.shape)} vs {tuple(b.values.shape)}")
    capacity = a.values.shape[0]
    values, tags = _top_capacity(torch.cat([a.values, b.values]), torch.cat([a.tags, b.tags]), capacity)
    return ReservoirSketch(values=values, tags=tags, count=a.count + b.count, key=_threefry.fold_in(a.key, b.count))


def reservoir_sample(state: ReservoirSketch) -> Tuple[Tensor, Tensor]:
    """``(values, valid)``: the sample and a boolean mask of live slots (the
    reservoir is only partly filled while ``count < capacity``)."""
    return state.values, torch.isfinite(state.tags)


register_sketch_state(ReservoirSketch, reservoir_merge)
