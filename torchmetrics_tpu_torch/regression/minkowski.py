# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MinkowskiDistance (counterpart of ``torchmetrics_tpu/regression/minkowski.py``).

State: ``minkowski_dist_sum`` (float32, 0-d).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.minkowski import (
    _check_p,
    _minkowski_distance_compute,
    _minkowski_distance_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MinkowskiDistance(Metric):
    """Minkowski distance of order ``p``."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_p(p)
        self.p = p
        self.add_state("minkowski_dist_sum", default=0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        """Fold a batch into the state."""
        preds, targets = self._inputs(preds, targets)
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(
            _jnp_dtype(preds), _jnp_dtype(targets), self.p
        )

    def compute(self) -> Tensor:
        """The ``p``-th root of the summed powers."""
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)
