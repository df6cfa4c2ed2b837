# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Specificity at fixed sensitivity (counterpart of
``torchmetrics_tpu/functional/classification/specificity_sensitivity.py``):
sensitivity at fixed specificity's curve and selection with the roles swapped."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import CurveState, ThresholdsArg
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_curve_point,
    _multiclass_curve_point,
    _multilabel_curve_point,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.functional.classification.sensitivity_specificity import (
    _binary_sensitivity_at_specificity_arg_validation,
    _convert_fpr_to_specificity,
    _first_best_at_constraint_device,
    _multiclass_sensitivity_at_specificity_arg_validation,
    _multilabel_sensitivity_at_specificity_arg_validation,
    _roc_points,
)
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


def _specificity_at_sensitivity(
    specificity: Tensor, sensitivity: Tensor, thresholds: Tensor, min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Max specificity whose sensitivity >= min_sensitivity, on the device."""
    return _first_best_at_constraint_device(specificity, sensitivity, thresholds, min_sensitivity)


def _binary_specificity_at_sensitivity_compute(
    state: CurveState, thresholds: Optional[Tensor], min_sensitivity: float, pos_label: int = 1
) -> Tuple[Tensor, Tensor]:
    """ROC -> (max specificity, threshold)."""
    fpr, sensitivity, thresholds = _binary_roc_compute(state, thresholds, pos_label)
    return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity)


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest specificity at minimum sensitivity, binary."""
    return _binary_curve_point(
        preds, target, thresholds, ignore_index, validate_args,
        lambda: _binary_sensitivity_at_specificity_arg_validation(min_sensitivity, thresholds, ignore_index),
        lambda state, thr: _binary_specificity_at_sensitivity_compute(state, thr, min_sensitivity),
    )


def _multiclass_specificity_at_sensitivity_compute(
    state: CurveState, num_classes: int, thresholds: Optional[Tensor], min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Per-class ROC -> per-class (specificity, threshold)."""
    curves = _multiclass_roc_compute(state, num_classes, thresholds)
    return _roc_points(curves, lambda sens, spec, thr: _specificity_at_sensitivity(spec, sens, thr, min_sensitivity))


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest specificity at minimum sensitivity, multiclass."""
    return _multiclass_curve_point(
        preds, target, num_classes, thresholds, ignore_index, validate_args,
        lambda: _multiclass_sensitivity_at_specificity_arg_validation(num_classes, min_sensitivity, thresholds, ignore_index),
        lambda state, thr: _multiclass_specificity_at_sensitivity_compute(state, num_classes, thr, min_sensitivity),
    )


def _multilabel_specificity_at_sensitivity_compute(
    state: CurveState, num_labels: int, thresholds: Optional[Tensor], ignore_index: Optional[int], min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Per-label ROC -> per-label (specificity, threshold)."""
    curves = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _roc_points(curves, lambda sens, spec, thr: _specificity_at_sensitivity(spec, sens, thr, min_sensitivity))


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest specificity at minimum sensitivity, multilabel."""
    return _multilabel_curve_point(
        preds, target, num_labels, thresholds, ignore_index, validate_args,
        lambda: _multilabel_sensitivity_at_specificity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index),
        lambda state, thr: _multilabel_specificity_at_sensitivity_compute(state, num_labels, thr, ignore_index, min_sensitivity),
    )


def specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_sensitivity: float,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching specificity at fixed sensitivity."""
    return _literal_task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_specificity_at_sensitivity(preds, target, min_sensitivity, thresholds, ignore_index, validate_args),
        lambda: multiclass_specificity_at_sensitivity(
            preds, target, num_classes, min_sensitivity, thresholds, ignore_index, validate_args
        ),
        lambda: multilabel_specificity_at_sensitivity(
            preds, target, num_labels, min_sensitivity, thresholds, ignore_index, validate_args
        ),
    )
