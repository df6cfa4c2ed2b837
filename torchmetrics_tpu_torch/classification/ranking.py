# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Multilabel ranking module metrics (counterpart of ``torchmetrics_tpu/classification/ranking.py``)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_format,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
    _ranking_reduce,
)
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class _MultilabelRankingMetric(Metric):
    """Shared state machine: the summed measure and the row count, both 0-d float32."""

    is_differentiable = False
    full_state_update = False

    _update_fn = None

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            if not isinstance(num_labels, int) or num_labels < 2:
                raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
            if ignore_index is not None and not isinstance(ignore_index, int):
                raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's summed measure and row count."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_ranking_format(preds, target, self.ignore_index)
        measure, total = type(self)._update_fn(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> Tensor:
        """The mean measure over every row folded so far."""
        return _ranking_reduce(self.measure, self.total)


class MultilabelCoverageError(_MultilabelRankingMetric):
    """Multilabel coverage error."""

    higher_is_better = False
    plot_lower_bound = 0.0
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_MultilabelRankingMetric):
    """Multilabel label-ranking average precision."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_MultilabelRankingMetric):
    """Multilabel ranking loss."""

    higher_is_better = False
    plot_lower_bound = 0.0
    _update_fn = staticmethod(_multilabel_ranking_loss_update)


__all__ = ["MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss"]
