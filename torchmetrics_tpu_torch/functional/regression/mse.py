# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Mean squared error (counterpart of ``torchmetrics_tpu/functional/regression/mse.py``).

The sums are float32 (inputs of any dtype are promoted to it, as
``jnp.promote_types(dtype, float32)`` does with 64-bit types off) and the
count a Python int, which an int32 state adds as int32.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """Sum of squared errors (per output) and the number of observations."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds.to(torch.float32) - target.to(torch.float32)
    return torch.sum(diff * diff, dim=0), target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, num_obs: Union[int, Tensor], squared: bool = True) -> Tensor:
    """MSE, or RMSE with ``squared=False``."""
    mse = sum_squared_error / num_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """Compute mean squared error."""
    preds, target = _to_tensors(preds, target)
    sum_squared_error, num_obs = _mean_squared_error_update(_jnp_dtype(preds), _jnp_dtype(target), num_outputs)
    return _mean_squared_error_compute(sum_squared_error, num_obs, squared=squared)
