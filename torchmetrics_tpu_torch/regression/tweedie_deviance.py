# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""TweedieDevianceScore (counterpart of ``torchmetrics_tpu/regression/tweedie_deviance.py``).

States: ``sum_deviance_score`` (float32, 0-d) and ``num_observations`` (int32, 0-d).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class TweedieDevianceScore(Metric):
    """Tweedie deviance score of a given ``power``."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=0.0, dist_reduce_fx="sum")
        self.add_state("num_observations", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        """Fold a batch into the state."""
        preds, targets = self._inputs(preds, targets)
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(
            preds.to(torch.float32), targets.to(torch.float32), self.power
        )
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        """Mean deviance."""
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
