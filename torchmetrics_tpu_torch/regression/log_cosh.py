# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""LogCoshError (counterpart of ``torchmetrics_tpu/regression/log_cosh.py``).

States: ``sum_log_cosh_error`` (float32, ``(num_outputs,)``) and ``total`` (int32, 0-d).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.log_cosh import _log_cosh_error_compute, _log_cosh_error_update
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_add
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class LogCoshError(Metric):
    """Log-cosh error, per output."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the state."""
        preds, target = self._inputs(preds, target)
        sum_log_cosh_error, num_obs = _log_cosh_error_update(
            preds.to(torch.float32), target.to(torch.float32), self.num_outputs
        )
        self.sum_log_cosh_error = _jnp_add(self.sum_log_cosh_error, sum_log_cosh_error)
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Mean log-cosh error."""
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)
