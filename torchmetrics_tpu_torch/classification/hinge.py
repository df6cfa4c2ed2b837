# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Hinge loss module metrics (counterpart of ``torchmetrics_tpu/classification/hinge.py``).

States: ``measures`` (float32, 0-d, or ``(C,)`` for one-vs-all) and
``total`` (int32, 0-d), the JAX package's dtypes.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_format,
    _binary_hinge_loss_tensor_validation,
    _binary_hinge_loss_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_format,
    _multiclass_hinge_loss_tensor_validation,
    _multiclass_hinge_loss_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


class BinaryHingeLoss(Metric):
    """Binary hinge loss."""

    is_differentiable = True
    higher_is_better = False
    plot_lower_bound = 0.0
    full_state_update = False

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measures", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's summed hinge measure and count."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _binary_hinge_loss_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_hinge_loss_format(preds, target, self.ignore_index)
        measures, total = _binary_hinge_loss_update(preds, target, self.squared)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Mean hinge loss."""
        return _hinge_loss_compute(self.measures, self.total)


class MulticlassHingeLoss(Metric):
    """Multiclass hinge loss, Crammer-Singer or one-vs-all (per class)."""

    is_differentiable = True
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_legend_name = 'Class'
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        measures = 0.0 if multiclass_mode == "crammer-singer" else torch.zeros(num_classes, dtype=torch.float32)
        self.add_state("measures", measures, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's summed hinge measures and count."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_hinge_loss_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_hinge_loss_format(preds, target, self.ignore_index)
        measures, total = _multiclass_hinge_loss_update(preds, target, self.squared, self.multiclass_mode)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Mean hinge loss (per class for one-vs-all)."""
        return _hinge_loss_compute(self.measures, self.total)


class HingeLoss(_ClassificationTaskWrapper):
    """Task-dispatching hinge loss."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _literal_task_call(
            task,
            num_classes,
            None,
            lambda: BinaryHingeLoss(squared, **kwargs),
            lambda: MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs),
        )


__all__ = ["BinaryHingeLoss", "HingeLoss", "MulticlassHingeLoss"]
