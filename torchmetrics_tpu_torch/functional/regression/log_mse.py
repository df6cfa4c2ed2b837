# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Mean squared log error (counterpart of ``torchmetrics_tpu/functional/regression/log_mse.py``)."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """Sum of squared log errors (0-d) and the number of elements."""
    _check_same_shape(preds, target)
    return torch.sum(torch.square(torch.log1p(preds) - torch.log1p(target))), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    """MSLE."""
    return sum_squared_log_error / num_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Compute mean squared log error."""
    preds, target = _float32_pair(preds, target)
    sum_squared_log_error, num_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, num_obs)
