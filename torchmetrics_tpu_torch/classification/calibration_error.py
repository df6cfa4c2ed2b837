# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Calibration error module metrics (counterpart of
``torchmetrics_tpu/classification/calibration_error.py``).

The states are three ``(n_bins,)`` float32 sums, ``bin_conf_sum``,
``bin_acc_sum`` and ``bin_count``, as in JAX: bin membership is decided per
sample, so per-bin sums folded at update and divided at compute bin like the
whole stream at once. The update reads nothing back to the host with
``validate_args=False``, so a CUDA graph captures it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_format,
    _binary_calibration_error_tensor_validation,
    _binary_calibration_error_update,
    _binning_update,
    _ce_compute_binned,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_format,
    _multiclass_calibration_error_tensor_validation,
    _multiclass_calibration_error_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


class _BinnedCalibrationError(Metric):
    """The per-bin sum states and their fold, shared by the binary and multiclass metrics."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def _create_bins(self, n_bins: int, norm: str, ignore_index: Optional[int], validate_args: bool) -> None:
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in ("bin_conf_sum", "bin_acc_sum", "bin_count"):
            self.add_state(name, torch.zeros(n_bins, dtype=torch.float32), dist_reduce_fx="sum")

    def _fold(self, confidences: Tensor, accuracies: Tensor) -> None:
        conf_sum, acc_sum, count = _binning_update(confidences, accuracies, self.n_bins)
        self.bin_conf_sum = self.bin_conf_sum + conf_sum
        self.bin_acc_sum = self.bin_acc_sum + acc_sum
        self.bin_count = self.bin_count + count

    def compute(self) -> Tensor:
        """The calibration error of everything folded so far."""
        return _ce_compute_binned(self.bin_conf_sum, self.bin_acc_sum, self.bin_count, norm=self.norm)


class BinaryCalibrationError(_BinnedCalibrationError):
    """Binary expected calibration error."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self._create_bins(n_bins, norm, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's per-bin confidence and accuracy sums."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_calibration_error_format(preds, target, self.ignore_index)
        self._fold(*_binary_calibration_error_update(preds, target))


class MulticlassCalibrationError(_BinnedCalibrationError):
    """Multiclass expected calibration error of the top-1 confidence."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self._create_bins(n_bins, norm, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's per-bin top-1 confidence and accuracy sums."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_calibration_error_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_calibration_error_format(preds, target, self.ignore_index)
        self._fold(*_multiclass_calibration_error_update(preds, target))


class CalibrationError(_ClassificationTaskWrapper):
    """Task-dispatching calibration error."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _literal_task_call(
            task,
            num_classes,
            None,
            lambda: BinaryCalibrationError(n_bins, norm, **kwargs),
            lambda: MulticlassCalibrationError(num_classes, n_bins, norm, **kwargs),
        )


__all__ = ["BinaryCalibrationError", "CalibrationError", "MulticlassCalibrationError"]
