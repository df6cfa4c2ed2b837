# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Segmentation module metrics (counterpart of ``torchmetrics_tpu/segmentation/metrics.py``).

States: ``GeneralizedDiceScore`` a float32 running sum of per-sample scores
and a float32 sample count; ``MeanIoU`` a float32 running sum of batch means
and an int32 batch count; all ``"sum"``-reduced. A sum or mean over the
batch adds in XLA's CPU order (``_sum_last_in_xla_order``, over the last
axis of the transposed scores with ``per_class``), and adds into a state
narrowed by ``set_dtype`` in the dtype ``jnp`` gives the sum (``_jnp_add``).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.segmentation.generalized_dice import (
    _generalized_dice_compute,
    _generalized_dice_update,
    _generalized_dice_validate_args,
)
from torchmetrics_tpu_torch.functional.segmentation.mean_iou import (
    _mean_iou_compute,
    _mean_iou_update,
    _mean_iou_validate_args,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order, _sum_last_in_xla_order
from torchmetrics_tpu_torch.utilities.data import _jnp_add

Tensor = torch.Tensor


def _batch_sum(scores: Tensor) -> Tensor:
    """``scores.sum(axis=0)`` of ``(N,)`` or ``(N, C)`` scores, in one fixed order."""
    return _sum_last_in_xla_order(scores.T if scores.ndim == 2 else scores)


def _batch_mean(scores: Tensor) -> Tensor:
    """``scores.mean(axis=0)`` of ``(N,)`` or ``(N, C)`` scores, in one fixed order."""
    return _mean_last_in_xla_order(scores.T if scores.ndim == 2 else scores)


class GeneralizedDiceScore(Metric):
    """Generalized dice score, averaged over the samples."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        weight_type: str = "square",
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.weight_type = weight_type
        self.input_format = input_format
        num_scores = num_classes - (0 if include_background else 1) if per_class else 1
        self.add_state("score", torch.zeros(num_scores), dist_reduce_fx="sum")
        self.add_state("samples", torch.zeros(1), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's per-sample scores into the state."""
        preds, target = self._inputs(preds, target)
        numerator, denominator = _generalized_dice_update(
            preds, target, self.num_classes, self.include_background, self.weight_type, self.input_format
        )
        self.score = _jnp_add(self.score, _batch_sum(_generalized_dice_compute(numerator, denominator, self.per_class)))
        self.samples = self.samples + preds.shape[0]

    def compute(self) -> Tensor:
        """Mean over the samples."""
        return self.score / self.samples


class MeanIoU(Metric):
    """Mean IoU, averaged over the batches."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _mean_iou_validate_args(num_classes, include_background, per_class, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.input_format = input_format
        num_scores = num_classes - (0 if include_background else 1) if per_class else 1
        self.add_state("score", torch.zeros(num_scores), dist_reduce_fx="sum")
        self.add_state("num_batches", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's mean IoU into the state."""
        preds, target = self._inputs(preds, target)
        intersection, union = _mean_iou_update(preds, target, self.num_classes, self.include_background, self.input_format)
        score = _mean_iou_compute(intersection, union, per_class=self.per_class)
        self.score = _jnp_add(self.score, _batch_mean(score))
        self.num_batches = self.num_batches + 1

    def compute(self) -> Tensor:
        """Mean over the batches."""
        return self.score / self.num_batches
