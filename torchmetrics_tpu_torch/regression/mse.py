# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MeanSquaredError (counterpart of ``torchmetrics_tpu/regression/mse.py``).

States: ``sum_squared_error`` (float32, ``(num_outputs,)``) and ``total``
(int32, 0-d). The JAX package's StateGuard domain contract is not ported
(see ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.robustness.guard import ArgSpec, DomainContract

Tensor = torch.Tensor


class MeanSquaredError(Metric):
    """Mean squared error (or its root with ``squared=False``), per output."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def domain_contract(self) -> DomainContract:
        # a single NaN/Inf sample poisons the float error sum forever: the
        # canonical StateGuard poison-probe target (robustness/guard.py)
        return DomainContract(
            args=(ArgSpec(name="preds", finite=True), ArgSpec(name="target", finite=True)),
            family="mean_squared_error",
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch of squared errors into the state."""
        preds, target = self._inputs(preds, target)
        sum_squared_error, num_obs = _mean_squared_error_update(_jnp_dtype(preds), _jnp_dtype(target), self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """MSE or RMSE."""
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)
