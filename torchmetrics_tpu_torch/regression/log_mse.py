# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MeanSquaredLogError (counterpart of ``torchmetrics_tpu/regression/log_mse.py``).

States: ``sum_squared_log_error`` (float32, 0-d) and ``total`` (int32, 0-d).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.log_mse import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MeanSquaredLogError(Metric):
    """Mean squared log error."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the state."""
        preds, target = self._inputs(preds, target)
        sum_squared_log_error, num_obs = _mean_squared_log_error_update(_jnp_dtype(preds), _jnp_dtype(target))
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """MSLE."""
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)
