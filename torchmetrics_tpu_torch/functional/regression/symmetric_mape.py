# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Symmetric mean absolute percentage error (counterpart of
``torchmetrics_tpu/functional/regression/symmetric_mape.py``)."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
) -> Tuple[Tensor, int]:
    """``2 * sum(|error| / max(|target| + |preds|, epsilon))`` (0-d) and the number of elements."""
    _check_same_shape(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return 2 * torch.sum(abs_per_error), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    """SMAPE."""
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Compute symmetric mean absolute percentage error."""
    preds, target = _float32_pair(preds, target)
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
