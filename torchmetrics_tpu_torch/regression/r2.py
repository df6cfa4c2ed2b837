# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""R2Score (counterpart of ``torchmetrics_tpu/regression/r2.py``).

States (the JAX package's names): ``sum_squared_error`` holds the sum of
squared targets, ``sum_error`` the sum of targets, ``residual`` the
residual sum of squares (float32, ``(num_outputs,)``), ``total`` the rows
(int32, 0-d). ``compute`` reads ``total`` on the host for its sample-count
check.
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.r2 import _r2_score_compute, _r2_score_update
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_add
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class R2Score(Metric):
    """R² score, optionally adjusted, over one or several outputs."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}")
        self.multioutput = multioutput

        self.add_state("sum_squared_error", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_error", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("residual", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the streaming sums."""
        preds, target = self._inputs(preds, target)
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds.to(torch.float32), target.to(torch.float32))
        self.sum_squared_error = _jnp_add(self.sum_squared_error, sum_squared_obs)
        self.sum_error = _jnp_add(self.sum_error, sum_obs)
        self.residual = _jnp_add(self.residual, rss)
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """R² from the streaming sums."""
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
