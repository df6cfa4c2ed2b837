# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ROC module metrics (counterpart of ``torchmetrics_tpu/classification/roc.py``).
They inherit the curve state machines, binned or exact; only ``compute`` differs."""
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
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


class BinaryROC(BinaryPrecisionRecallCurve):
    """Binary ROC curve."""

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Compute fpr/tpr/thresholds."""
        return _binary_roc_compute(self._curve_state(), self.thresholds)

    def plot(self, curve: Optional[Tuple] = None, score: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("False positive rate", "True positive rate"))


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """Multiclass ROC curves (``average="micro"`` or ``"macro"`` merges them)."""

    def compute(self):
        """Compute per-class fpr/tpr/thresholds."""
        return _multiclass_roc_compute(self._curve_state(), self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Optional[Tuple] = None, score: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("False positive rate", "True positive rate"))


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Multilabel ROC curves."""

    def compute(self):
        """Compute per-label fpr/tpr/thresholds."""
        return _multilabel_roc_compute(self._curve_state(), self.num_labels, self.thresholds, self.ignore_index)

    def plot(self, curve: Optional[Tuple] = None, score: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("False positive rate", "True positive rate"))


class ROC(_ClassificationTaskWrapper):
    """Task-dispatching ROC."""

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
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryROC(**kwargs),
            lambda: MulticlassROC(num_classes, **kwargs),
            lambda: MultilabelROC(num_labels, **kwargs),
        )


__all__ = ["BinaryROC", "MulticlassROC", "MultilabelROC", "ROC"]
