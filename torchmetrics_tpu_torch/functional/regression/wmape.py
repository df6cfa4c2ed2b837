# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Weighted mean absolute percentage error (counterpart of
``torchmetrics_tpu/functional/regression/wmape.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum of absolute errors and sum of ``|target|`` (both 0-d)."""
    _check_same_shape(preds, target)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = 1.17e-06
) -> Tensor:
    """WMAPE."""
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Compute weighted mean absolute percentage error."""
    preds, target = _float32_pair(preds, target)
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
