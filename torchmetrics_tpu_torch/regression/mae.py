# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MeanAbsoluteError (counterpart of ``torchmetrics_tpu/regression/mae.py``).

States: ``sum_abs_error`` (float32, ``(num_outputs,)``) and ``total`` (int32, 0-d).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_add, _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MeanAbsoluteError(Metric):
    """Mean absolute error, per output."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_abs_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch of absolute errors into the state."""
        preds, target = self._inputs(preds, target)
        sum_abs_error, num_obs = _mean_absolute_error_update(_jnp_dtype(preds), _jnp_dtype(target), self.num_outputs)
        self.sum_abs_error = _jnp_add(self.sum_abs_error, sum_abs_error)
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """MAE."""
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
