# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""RelativeSquaredError (counterpart of ``torchmetrics_tpu/regression/rse.py``).

States: ``sum_squared_obs``, ``sum_obs``, ``sum_squared_error`` (float32,
``(num_outputs,)``) and ``total`` (int32, 0-d).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.r2 import _r2_score_update
from torchmetrics_tpu_torch.functional.regression.rse import _relative_squared_error_compute
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_add
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class RelativeSquaredError(Metric):
    """Relative squared error (or its root with ``squared=False``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.squared = squared
        self.add_state("sum_squared_obs", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_obs", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the streaming sums."""
        preds, target = self._inputs(preds, target)
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds.to(torch.float32), target.to(torch.float32))
        self.sum_squared_obs = _jnp_add(self.sum_squared_obs, sum_squared_obs)
        self.sum_obs = _jnp_add(self.sum_obs, sum_obs)
        self.sum_squared_error = _jnp_add(self.sum_squared_error, rss)
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """RSE from the streaming sums."""
        return _relative_squared_error_compute(
            self.sum_squared_obs, self.sum_obs, self.sum_squared_error, self.total, squared=self.squared
        )
