# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Matthews correlation coefficient module metrics (counterpart of
``torchmetrics_tpu/classification/matthews_corrcoef.py``); they ride the
confusion-matrix state."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    """Binary MCC."""

    higher_is_better = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        """Compute the MCC from the confusion matrix."""
        return _matthews_corrcoef_reduce(self.confmat)


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    """Multiclass MCC."""

    higher_is_better = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        """Compute the MCC from the confusion matrix."""
        return _matthews_corrcoef_reduce(self.confmat)


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    """Multilabel MCC."""

    higher_is_better = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        """Compute the MCC from the per-label confusion matrices."""
        return _matthews_corrcoef_reduce(self.confmat)


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task-dispatching MCC."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryMatthewsCorrCoef(threshold, **kwargs),
            lambda: MulticlassMatthewsCorrCoef(num_classes, **kwargs),
            lambda: MultilabelMatthewsCorrCoef(num_labels, threshold, **kwargs),
        )


__all__ = ["BinaryMatthewsCorrCoef", "MulticlassMatthewsCorrCoef", "MultilabelMatthewsCorrCoef", "MatthewsCorrCoef"]
