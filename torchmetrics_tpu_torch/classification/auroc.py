# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""AUROC module metrics (counterpart of ``torchmetrics_tpu/classification/auroc.py``).
They inherit the curve state machines, binned or exact; only ``compute`` differs."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import ThresholdsArg
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binary AUROC."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        self.max_fpr = max_fpr
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """Compute AUROC."""
        return _binary_auroc_compute(self._curve_state(), self.thresholds, self.max_fpr)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Multiclass AUROC (exact by default: one batched sort over the classes at compute)."""

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
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        self.average = average  # type: ignore[assignment]
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """Compute AUROC."""
        return _multiclass_auroc_compute(self._curve_state(), self.num_classes, self.average, self.thresholds)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Multilabel AUROC."""

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
        """Compute AUROC."""
        return _multilabel_auroc_compute(self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        return self._plot(val, ax)


class AUROC(_ClassificationTaskWrapper):
    """Task-dispatching AUROC."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: ThresholdsArg = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryAUROC(max_fpr, **kwargs),
            lambda: MulticlassAUROC(num_classes, average, **kwargs),
            lambda: MultilabelAUROC(num_labels, average, **kwargs),
        )


__all__ = ["BinaryAUROC", "MulticlassAUROC", "MultilabelAUROC", "AUROC"]
