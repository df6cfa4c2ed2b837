# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""SensitivityAtSpecificity module metrics (counterpart of
``torchmetrics_tpu/classification/sensitivity_specificity.py``). They inherit the
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
from torchmetrics_tpu_torch.functional.classification.sensitivity_specificity import (
    _binary_sensitivity_at_specificity_arg_validation,
    _binary_sensitivity_at_specificity_compute,
    _multiclass_sensitivity_at_specificity_arg_validation,
    _multiclass_sensitivity_at_specificity_compute,
    _multilabel_sensitivity_at_specificity_arg_validation,
    _multilabel_sensitivity_at_specificity_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


class BinarySensitivityAtSpecificity(BinaryPrecisionRecallCurve):
    """Binary max sensitivity at min specificity."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(
        self,
        min_specificity: float,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_sensitivity_at_specificity_arg_validation(min_specificity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        """(best value, its threshold)."""
        return _binary_sensitivity_at_specificity_compute(self._curve_state(), self.thresholds, self.min_specificity)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MulticlassSensitivityAtSpecificity(MulticlassPrecisionRecallCurve):
    """Multiclass max sensitivity at min specificity, per class."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        min_specificity: float,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_sensitivity_at_specificity_arg_validation(num_classes, min_specificity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        """Per-class (best value, its threshold)."""
        return _multiclass_sensitivity_at_specificity_compute(
            self._curve_state(), self.num_classes, self.thresholds, self.min_specificity
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MultilabelSensitivityAtSpecificity(MultilabelPrecisionRecallCurve):
    """Multilabel max sensitivity at min specificity, per label."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        min_specificity: float,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_sensitivity_at_specificity_arg_validation(num_labels, min_specificity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        """Per-label (best value, its threshold)."""
        return _multilabel_sensitivity_at_specificity_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_specificity
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Task-dispatching SensitivityAtSpecificity."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_specificity: float,
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
            lambda: BinarySensitivityAtSpecificity(min_specificity, thresholds, ignore_index, validate_args, **kwargs),
            lambda: MulticlassSensitivityAtSpecificity(num_classes, min_specificity, thresholds, ignore_index, validate_args, **kwargs),
            lambda: MultilabelSensitivityAtSpecificity(num_labels, min_specificity, thresholds, ignore_index, validate_args, **kwargs),
        )


__all__ = ["BinarySensitivityAtSpecificity", "MulticlassSensitivityAtSpecificity", "MultilabelSensitivityAtSpecificity", "SensitivityAtSpecificity"]
