# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MeanAbsolutePercentageError (counterpart of ``torchmetrics_tpu/regression/mape.py``).

States: ``sum_abs_per_error`` and ``total``, both float32 0-d, as in the JAX package.
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the state."""
        preds, target = self._inputs(preds, target)
        sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(_jnp_dtype(preds), _jnp_dtype(target))
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """MAPE."""
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)
