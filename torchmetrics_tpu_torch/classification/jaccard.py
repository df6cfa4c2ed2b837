# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Jaccard index module metrics (counterpart of ``torchmetrics_tpu/classification/jaccard.py``);
they ride the confusion-matrix state."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.functional.classification.jaccard import _jaccard_index_reduce
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


def _validate_average(average: Optional[str]) -> None:
    allowed_average = ["micro", "macro", "weighted", "none", None]
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}.")


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Binary intersection over union."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        zero_division = kwargs.pop("zero_division", 0)
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """Compute the index from the confusion matrix."""
        return _jaccard_index_reduce(self.confmat, average="binary", zero_division=self.zero_division)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Multiclass intersection over union."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        zero_division = kwargs.pop("zero_division", 0)
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_average(average)
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """Compute the index from the confusion matrix."""
        return _jaccard_index_reduce(self.confmat, average=self.average, ignore_index=self.ignore_index, zero_division=self.zero_division)


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    """Multilabel intersection over union."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        zero_division = kwargs.pop("zero_division", 0)
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_average(average)
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """Compute the index from the per-label confusion matrices."""
        return _jaccard_index_reduce(self.confmat, average=self.average, zero_division=self.zero_division)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task-dispatching Jaccard index."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryJaccardIndex(threshold, **kwargs),
            lambda: MulticlassJaccardIndex(num_classes, average, **kwargs),
            lambda: MultilabelJaccardIndex(num_labels, threshold, average, **kwargs),
        )


__all__ = ["BinaryJaccardIndex", "MulticlassJaccardIndex", "MultilabelJaccardIndex", "JaccardIndex"]
