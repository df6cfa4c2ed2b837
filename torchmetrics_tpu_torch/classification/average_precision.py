# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""AveragePrecision module metrics (counterpart of
``torchmetrics_tpu/classification/average_precision.py``). They inherit the
curve state machines, binned or exact; only ``compute`` differs."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.auroc import _multilabel_auroc_arg_validation
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_arg_validation,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import ThresholdsArg
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Binary average precision."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def compute(self) -> Tensor:
        """Compute average precision."""
        return _binary_average_precision_compute(self._curve_state(), self.thresholds)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Multiclass average precision (exact by default: one batched sort over the classes at compute)."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        self.average = average  # type: ignore[assignment]
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """Compute average precision."""
        return _multiclass_average_precision_compute(self._curve_state(), self.num_classes, self.average, self.thresholds)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Multilabel average precision."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """Compute average precision."""
        return _multilabel_average_precision_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class AveragePrecision(_ClassificationTaskWrapper):
    """Task-dispatching AveragePrecision."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: ThresholdsArg = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryAveragePrecision(**kwargs),
            lambda: MulticlassAveragePrecision(num_classes, average, **kwargs),
            lambda: MultilabelAveragePrecision(num_labels, average, **kwargs),
        )


__all__ = ["BinaryAveragePrecision", "MulticlassAveragePrecision", "MultilabelAveragePrecision", "AveragePrecision"]
