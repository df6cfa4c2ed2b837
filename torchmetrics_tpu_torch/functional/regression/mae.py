# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Mean absolute error (counterpart of ``torchmetrics_tpu/functional/regression/mae.py``)."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    """Sum of absolute errors (float32, per output) and the number of observations."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    return torch.sum(torch.abs(preds.to(torch.float32) - target.to(torch.float32)), dim=0), target.shape[0]


def _mean_absolute_error_compute(sum_abs_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    """MAE."""
    return sum_abs_error / num_obs


def mean_absolute_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    """Compute mean absolute error."""
    preds, target = _to_tensors(preds, target)
    sum_abs_error, num_obs = _mean_absolute_error_update(_jnp_dtype(preds), _jnp_dtype(target), num_outputs)
    return _mean_absolute_error_compute(sum_abs_error, num_obs)
