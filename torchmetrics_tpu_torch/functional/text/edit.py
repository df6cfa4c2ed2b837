# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Edit distance (counterpart of ``torchmetrics_tpu/functional/text/edit.py``)."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _batch_edit_distance

Tensor = torch.Tensor


def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
) -> Tensor:
    """Per-pair character edit distances, int32 (JAX's ``jnp.int32``)."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if not all(isinstance(x, str) for x in preds):
        raise ValueError(f"Expected all values in argument `preds` to be string type, but got {preds}")
    if not all(isinstance(x, str) for x in target):
        raise ValueError(f"Expected all values in argument `target` to be string type, but got {target}")
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    distance = _batch_edit_distance([list(p) for p in preds], [list(t) for t in target], substitution_cost)
    return torch.from_numpy(distance.astype("int32"))


def _edit_distance_compute(
    edit_scores: Tensor,
    num_elements: Union[Tensor, int],
    reduction: Optional[str] = "mean",
) -> Tensor:
    """Reduce the per-pair distances: the int32 sum, its mean as float32, or the distances."""
    if edit_scores.numel() == 0:
        return torch.tensor(0, dtype=torch.int32)
    if reduction == "mean":
        return edit_scores.sum(dtype=torch.int32) / torch.as_tensor(num_elements, dtype=torch.int32).to(edit_scores.device)
    if reduction == "sum":
        return edit_scores.sum(dtype=torch.int32)
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
) -> Tensor:
    """Character edit distance."""
    distance = _edit_distance_update(preds, target, substitution_cost)
    return _edit_distance_compute(distance, num_elements=distance.numel(), reduction=reduction)
