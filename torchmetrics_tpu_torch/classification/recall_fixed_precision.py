# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""RecallAtFixedPrecision module metrics (counterpart of
``torchmetrics_tpu/classification/recall_fixed_precision.py``). They inherit the
precision-recall curve's state machines, binned (kernel K1's int32 state)
or exact; only ``compute`` differs."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import ThresholdsArg
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _multiclass_recall_at_fixed_precision_arg_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_arg_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """Binary max recall at min precision."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(
        self,
        min_precision: float,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        """(best value, its threshold)."""
        return _binary_recall_at_fixed_precision_compute(self._curve_state(), self.thresholds, self.min_precision)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """Multiclass max recall at min precision, per class."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        """Per-class (best value, its threshold)."""
        return _multiclass_recall_at_fixed_precision_arg_compute(
            self._curve_state(), self.num_classes, self.thresholds, self.min_precision
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """Multilabel max recall at min precision, per label."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        min_precision: float,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        """Per-label (best value, its threshold)."""
        return _multilabel_recall_at_fixed_precision_arg_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_precision
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task-dispatching RecallAtFixedPrecision."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_precision: float,
        thresholds: ThresholdsArg = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _literal_task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryRecallAtFixedPrecision(min_precision, thresholds, ignore_index, validate_args, **kwargs),
            lambda: MulticlassRecallAtFixedPrecision(num_classes, min_precision, thresholds, ignore_index, validate_args, **kwargs),
            lambda: MultilabelRecallAtFixedPrecision(num_labels, min_precision, thresholds, ignore_index, validate_args, **kwargs),
        )


__all__ = ["BinaryRecallAtFixedPrecision", "MulticlassRecallAtFixedPrecision", "MultilabelRecallAtFixedPrecision", "RecallAtFixedPrecision"]
