# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ExplainedVariance (counterpart of ``torchmetrics_tpu/regression/explained_variance.py``).

States: ``sum_error``, ``sum_squared_error``, ``sum_target``,
``sum_squared_target`` and ``num_obs``, all float32 0-d defaults (a
multi-output batch broadcasts the sums to ``(num_outputs,)``, as in JAX).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.explained_variance import (
    ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_update,
)
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class ExplainedVariance(Metric):
    """Explained variance."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}")
        self.multioutput = multioutput
        self.add_state("sum_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("sum_squared_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("sum_target", default=0.0, dist_reduce_fx="sum")
        self.add_state("sum_squared_target", default=0.0, dist_reduce_fx="sum")
        self.add_state("num_obs", default=0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the streaming sums."""
        preds, target = self._inputs(preds, target)
        num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(
            preds.to(torch.float32), target.to(torch.float32)
        )
        self.num_obs = self.num_obs + num_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Tensor:
        """Explained variance from the streaming sums."""
        return _explained_variance_compute(
            self.num_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
