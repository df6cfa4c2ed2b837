# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""IoU-family functional metrics (counterpart of ``torchmetrics_tpu/functional/detection/iou.py``).

One pipeline over the pairwise matrices of :mod:`.helpers`, plain PyTorch
on the input's device (numpy input goes to the card).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchmetrics_tpu_torch.functional.detection.helpers import (
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)
from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order
from torchmetrics_tpu_torch.utilities.data import _to_tensor

Tensor = torch.Tensor


def _iou_family_update(
    kernel: Callable[[Tensor, Tensor], Tensor],
    preds: Any,
    target: Any,
    iou_threshold: Optional[float],
    replacement_val: float = 0,
) -> Tensor:
    """The pairwise matrix with entries below ``iou_threshold`` replaced."""
    preds = _to_tensor(preds)
    target = _to_tensor(target, preds.device)
    if preds.ndim != 2 or preds.shape[-1] != 4:
        raise ValueError(f"Expected preds to be of shape (N, 4) but got {tuple(preds.shape)}")
    if target.ndim != 2 or target.shape[-1] != 4:
        raise ValueError(f"Expected target to be of shape (N, 4) but got {tuple(target.shape)}")
    mat = kernel(preds, target)
    if iou_threshold is not None:
        mat = mat.masked_fill(mat < iou_threshold, replacement_val)
    return mat


def _iou_family_compute(mat: Tensor, aggregate: bool = True) -> Tensor:
    """The mean of the diagonal (the matched pairs), summed in XLA's order
    (the same bits on every device), or the whole matrix."""
    if not aggregate:
        return mat
    return _mean_last_in_xla_order(torch.diagonal(mat)) if mat.numel() > 0 else torch.tensor(0.0, device=mat.device)


def _make_public(kernel: Callable[[Tensor, Tensor], Tensor], name: str) -> Callable:
    def fn(
        preds: Any,
        target: Any,
        iou_threshold: Optional[float] = None,
        replacement_val: float = 0,
        aggregate: bool = True,
    ) -> Tensor:
        mat = _iou_family_update(kernel, preds, target, iou_threshold, replacement_val)
        return _iou_family_compute(mat, aggregate)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = (
        f"Compute {name.replace('_', ' ')} between two sets of ``xyxy`` boxes.\n\n"
        "With ``aggregate=True`` (default) returns the mean of the matched\n"
        "(diagonal) pairs; otherwise the full pairwise matrix. ``iou_threshold``\n"
        "replaces entries below it with ``replacement_val``."
    )
    return fn


intersection_over_union = _make_public(box_iou, "intersection_over_union")
generalized_intersection_over_union = _make_public(generalized_box_iou, "generalized_intersection_over_union")
distance_intersection_over_union = _make_public(distance_box_iou, "distance_intersection_over_union")
complete_intersection_over_union = _make_public(complete_box_iou, "complete_intersection_over_union")
