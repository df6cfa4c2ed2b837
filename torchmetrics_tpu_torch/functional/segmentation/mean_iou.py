# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Mean IoU for segmentation (counterpart of ``torchmetrics_tpu/functional/segmentation/mean_iou.py``).

The intersection and the two sums are int32 counts over the pixels, exact
on every device, then float32. The mean over the classes is XLA's CPU mean
(``_mean_last_in_xla_order``), so a value is the same bits on the card and
on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.segmentation.utils import _ignore_background, _segmentation_format, _spatial_sum
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order, _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _mean_iou_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    input_format: str = "one-hot",
) -> None:
    """Validate the non-tensor arguments."""
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if input_format not in ("one-hot", "index"):
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}.")


def _mean_iou_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = False,
    input_format: str = "one-hot",
) -> Tuple[Tensor, Tensor]:
    """Per-sample, per-class intersection and union, float32 ``(N, C)``."""
    if input_format == "one-hot":
        _check_same_shape(preds, target)
    if preds.ndim < (3 if input_format == "one-hot" else 2):
        raise ValueError(f"Expected both `preds` and `target` to have at least 3 dimensions, but got {preds.ndim}.")
    preds, target = _segmentation_format(preds, target, num_classes, input_format)
    if not include_background:
        preds, target = _ignore_background(preds, target)
    reduce_axis = tuple(range(2, preds.ndim))
    preds_b = preds.to(torch.bool)
    target_b = target.to(torch.bool)
    intersection = _spatial_sum(preds_b & target_b, reduce_axis).to(torch.float32)
    target_sum = _spatial_sum(target_b, reduce_axis).to(torch.float32)
    pred_sum = _spatial_sum(preds_b, reduce_axis).to(torch.float32)
    union = target_sum + pred_sum - intersection
    return intersection, union


def _mean_iou_compute(intersection: Tensor, union: Tensor, per_class: bool = False) -> Tensor:
    """Per-class IoU, or its mean over the classes."""
    val = _safe_divide(intersection, union)
    return val if per_class else _mean_last_in_xla_order(val)


def mean_iou(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    input_format: str = "one-hot",
) -> Tensor:
    """Mean intersection over union per sample, ``(N,)`` or ``(N, C)`` with ``per_class``."""
    preds, target = _to_tensors(preds, target)
    _mean_iou_validate_args(num_classes, include_background, per_class, input_format)
    intersection, union = _mean_iou_update(preds, target, num_classes, include_background, input_format)
    return _mean_iou_compute(intersection, union, per_class)
