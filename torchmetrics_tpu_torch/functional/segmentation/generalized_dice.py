# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Generalized dice score (counterpart of ``torchmetrics_tpu/functional/segmentation/generalized_dice.py``).

The intersection and the sums are int32 counts over the pixels (float sums
for float one-hot inputs), then float32. The sum over the classes adds in
XLA's CPU order (``_sum_last_in_xla_order``). An empty ground-truth class
(an infinite weight) takes the sample's largest finite weight: the JAX
package's deliberate deviation from the reference (MONAI's behaviour),
ported as it stands.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.segmentation.utils import _ignore_background, _segmentation_format, _spatial_sum
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, _sum_last_in_xla_order
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _generalized_dice_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    weight_type: str,
    input_format: str,
) -> None:
    """Validate the non-tensor arguments."""
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if weight_type not in ("square", "simple", "linear"):
        raise ValueError(
            f"Expected argument `weight_type` to be one of 'square', 'simple', 'linear', but got {weight_type}."
        )
    if input_format not in ("one-hot", "index"):
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}.")


def _generalized_dice_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> Tuple[Tensor, Tensor]:
    """Per-sample, per-class weighted numerator and denominator, float32 ``(N, C)``."""
    if input_format == "one-hot":
        _check_same_shape(preds, target)
    if preds.ndim < (3 if input_format == "one-hot" else 2):
        raise ValueError(f"Expected both `preds` and `target` to have at least 3 dimensions, but got {preds.ndim}.")
    preds, target = _segmentation_format(preds, target, num_classes, input_format)
    if not include_background:
        preds, target = _ignore_background(preds, target)

    reduce_axis = tuple(range(2, target.ndim))
    intersection = _spatial_sum(preds * target, reduce_axis).to(torch.float32)
    target_sum = _spatial_sum(target, reduce_axis).to(torch.float32)
    pred_sum = _spatial_sum(preds, reduce_axis).to(torch.float32)
    cardinality = target_sum + pred_sum

    if weight_type == "simple":
        weights = 1.0 / target_sum
    elif weight_type == "linear":
        weights = torch.ones_like(target_sum)
    else:  # square
        weights = 1.0 / (target_sum**2)

    infs = torch.isinf(weights)
    finite = torch.where(infs, torch.zeros_like(weights), weights)
    w_max = finite.amax(dim=1, keepdim=True)
    weights = torch.where(infs, w_max.expand(weights.shape), weights)

    numerator = 2.0 * intersection * weights
    denominator = cardinality * weights
    return numerator, denominator


def _generalized_dice_compute(numerator: Tensor, denominator: Tensor, per_class: bool = True) -> Tensor:
    """Per-class scores, or the class sums' ratio."""
    if not per_class:
        numerator = _sum_last_in_xla_order(numerator)
        denominator = _sum_last_in_xla_order(denominator)
    return _safe_divide(numerator, denominator)


def generalized_dice_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> Tensor:
    """Generalized dice score per sample, ``(N,)`` or ``(N, C)`` with ``per_class``."""
    preds, target = _to_tensors(preds, target)
    _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
    numerator, denominator = _generalized_dice_update(
        preds, target, num_classes, include_background, weight_type, input_format
    )
    return _generalized_dice_compute(numerator, denominator, per_class)
