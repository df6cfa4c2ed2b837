# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""PrecisionRecallCurve module metrics, binary and multiclass, binned mode
(counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``).

The state is the fixed-shape ``(T, ..., 2, 2)`` int32 confusion tensor with
``dist_reduce_fx="sum"``, written each batch by kernel K1 in one launch. The
module asks once, at init, whether its grid ascends and whether K1's O(1)
bin index is exact on it. The exact mode
(``thresholds=None``, unbounded ``cat`` states) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.classification.base import _MULTILABEL_MESSAGE, _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ThresholdsArg,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _require_binned,
    _thresholds_ascend,
    _uniform_grid,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

Tensor = torch.Tensor


class _AbstractCurveMetric(Metric):
    """Shared state plumbing for the curve family."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    confmat: Tensor
    thresholds: Tensor

    def _create_curve_state(self, state_shape: Tuple[int, ...]) -> None:
        self.add_state("confmat", torch.zeros(state_shape, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_curve_state(self, state: Tensor) -> None:
        self.confmat = self.confmat + state

    def _curve_state(self) -> Tensor:
        return self.confmat

    def to(self, device) -> "_AbstractCurveMetric":
        super().to(device)
        self.thresholds = self.thresholds.to(self.device)
        return self


class BinaryPrecisionRecallCurve(_AbstractCurveMetric):
    """Binary precision-recall curve (binned)."""

    def __init__(
        self,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _require_binned(thresholds)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        self._thresholds_ascend = _thresholds_ascend(self.thresholds)
        self._thresholds_affine = _uniform_grid(self.thresholds) if self._thresholds_ascend else None
        self._create_curve_state((len(self.thresholds), 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index)
        state = _binary_precision_recall_curve_update(
            preds, target, self.thresholds, self._thresholds_ascend, self._thresholds_affine
        )
        self._update_curve_state(state)

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Compute the final curve."""
        return _binary_precision_recall_curve_compute(self._curve_state(), self.thresholds)


class MulticlassPrecisionRecallCurve(_AbstractCurveMetric):
    """Multiclass precision-recall curves (binned)."""

    def __init__(
        self,
        num_classes: int,
        thresholds: ThresholdsArg = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _require_binned(thresholds)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        self._thresholds_ascend = _thresholds_ascend(self.thresholds)
        self._thresholds_affine = _uniform_grid(self.thresholds) if self._thresholds_ascend else None
        len_t = len(self.thresholds)
        self._create_curve_state((len_t, 2, 2) if average == "micro" else (len_t, num_classes, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average
        )
        state = _multiclass_precision_recall_curve_update(
            preds, target, self.num_classes, self.thresholds, self.average, self._thresholds_ascend, self._thresholds_affine
        )
        self._update_curve_state(state)

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Compute the final per-class curves."""
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds, self.average)


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task-dispatching PrecisionRecallCurve (binary and multiclass, binned)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: ThresholdsArg = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        raise NotImplementedError(_MULTILABEL_MESSAGE)


__all__ = ["BinaryPrecisionRecallCurve", "MulticlassPrecisionRecallCurve", "PrecisionRecallCurve"]
