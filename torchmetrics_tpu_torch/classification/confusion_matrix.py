# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Confusion-matrix module metrics (counterpart of
``torchmetrics_tpu/classification/confusion_matrix.py``).

One fixed-shape int32 ``confmat`` state with ``dist_reduce_fx="sum"``: 2x2,
C x C, or L x 2 x 2. The count has a fixed size and reads nothing back to
the host, so a fused plan captures the update in its CUDA graph.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_compute,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_compute,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_compute,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


class BinaryConfusionMatrix(Metric):
    """Binary 2x2 confusion matrix."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target)

    def compute(self) -> Tensor:
        """Compute the confusion matrix."""
        return _binary_confusion_matrix_compute(self.confmat, self.normalize)

    def plot(self, val: Optional[Tensor] = None, ax: Any = None, add_text: bool = True, labels: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class MulticlassConfusionMatrix(Metric):
    """C x C confusion matrix: rows are true classes, columns predicted ones."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(preds, target)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, self.num_classes, self.ignore_index)

    def compute(self) -> Tensor:
        """Compute the confusion matrix."""
        return _multiclass_confusion_matrix_compute(self.confmat, self.normalize)

    def plot(self, val: Optional[Tensor] = None, ax: Any = None, add_text: bool = True, labels: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class MultilabelConfusionMatrix(Metric):
    """L x 2 x 2 confusion matrices, one per label."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_labels, 2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_confusion_matrix_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, self.num_labels)

    def compute(self) -> Tensor:
        """Compute the confusion matrices."""
        return _multilabel_confusion_matrix_compute(self.confmat, self.normalize)


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task-dispatching ConfusionMatrix."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryConfusionMatrix(threshold, **kwargs),
            lambda: MulticlassConfusionMatrix(num_classes, **kwargs),
            lambda: MultilabelConfusionMatrix(num_labels, threshold, **kwargs),
        )


__all__ = ["BinaryConfusionMatrix", "MulticlassConfusionMatrix", "MultilabelConfusionMatrix", "ConfusionMatrix"]
