# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Sensitivity at fixed specificity (counterpart of
``torchmetrics_tpu/functional/classification/sensitivity_specificity.py``).

The curve is the ROC's (binned from kernel K1's state, or exact), with
specificity ``1 - fpr``. The selection differs from the PR-curve families':
the FIRST point of maximal primary value among those meeting the
constraint wins, with no further tie-break and no zero-value sentinel; no
point meeting it gives ``(0, 1e6)``. Masking with ``-inf`` and one
``torch.argmax`` keep that first-match order, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    ThresholdsArg,
    _binary_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_arg_validation,
)
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_curve_point,
    _check_min_value,
    _constrained_rows,
    _multiclass_curve_point,
    _multilabel_curve_point,
    _select_per_curve,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


def _convert_fpr_to_specificity(fpr: Tensor) -> Tensor:
    """specificity = 1 - fpr."""
    return 1 - fpr


def _first_best_at_constraint_device(
    primary: Tensor, constraint: Tensor, thresholds: Tensor, min_constraint: float
) -> Tuple[Tensor, Tensor]:
    """``argmax(primary)`` among the points with ``constraint >= min_constraint``,
    along the last axis (leading axes are independent rows); no such point:
    ``(0, 1e6)``, float32. No host sync."""
    primary, constraint, thresholds, valid = _constrained_rows(primary, constraint, thresholds, min_constraint)
    idx = torch.argmax(torch.where(valid, primary, float("-inf")), dim=-1, keepdim=True)
    has = valid.any(-1)
    best = torch.where(has, primary.gather(-1, idx).squeeze(-1), 0.0).to(torch.float32)
    best_threshold = torch.where(has, thresholds.gather(-1, idx).squeeze(-1), 1e6).to(torch.float32)
    return best, best_threshold


def _sensitivity_at_specificity(
    sensitivity: Tensor, specificity: Tensor, thresholds: Tensor, min_specificity: float
) -> Tuple[Tensor, Tensor]:
    """Max sensitivity whose specificity >= min_specificity, on the device."""
    return _first_best_at_constraint_device(sensitivity, specificity, thresholds, min_specificity)


def _binary_sensitivity_at_specificity_arg_validation(
    min_specificity: float, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _check_min_value("min_specificity", min_specificity)


def _binary_sensitivity_at_specificity_compute(
    state: CurveState, thresholds: Optional[Tensor], min_specificity: float, pos_label: int = 1
) -> Tuple[Tensor, Tensor]:
    """ROC -> (max sensitivity, threshold)."""
    fpr, sensitivity, thresholds = _binary_roc_compute(state, thresholds, pos_label)
    return _sensitivity_at_specificity(sensitivity, _convert_fpr_to_specificity(fpr), thresholds, min_specificity)


def binary_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    min_specificity: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest sensitivity at minimum specificity, binary."""
    return _binary_curve_point(
        preds, target, thresholds, ignore_index, validate_args,
        lambda: _binary_sensitivity_at_specificity_arg_validation(min_specificity, thresholds, ignore_index),
        lambda state, thr: _binary_sensitivity_at_specificity_compute(state, thr, min_specificity),
    )


def _multiclass_sensitivity_at_specificity_arg_validation(
    num_classes: int, min_specificity: float, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _check_min_value("min_specificity", min_specificity)


def _roc_points(curves, select) -> Tuple[Tensor, Tensor]:
    """``select(tpr, 1 - fpr, thresholds)`` over per-class ROC curves (stacked or lists)."""
    return _select_per_curve(curves, lambda fpr, tpr, thr: select(tpr, _convert_fpr_to_specificity(fpr), thr))


def _multiclass_sensitivity_at_specificity_compute(
    state: CurveState, num_classes: int, thresholds: Optional[Tensor], min_specificity: float
) -> Tuple[Tensor, Tensor]:
    """Per-class ROC -> per-class (sensitivity, threshold)."""
    curves = _multiclass_roc_compute(state, num_classes, thresholds)
    return _roc_points(curves, lambda sens, spec, thr: _sensitivity_at_specificity(sens, spec, thr, min_specificity))


def multiclass_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_specificity: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest sensitivity at minimum specificity, multiclass."""
    return _multiclass_curve_point(
        preds, target, num_classes, thresholds, ignore_index, validate_args,
        lambda: _multiclass_sensitivity_at_specificity_arg_validation(num_classes, min_specificity, thresholds, ignore_index),
        lambda state, thr: _multiclass_sensitivity_at_specificity_compute(state, num_classes, thr, min_specificity),
    )


def _multilabel_sensitivity_at_specificity_arg_validation(
    num_labels: int, min_specificity: float, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _check_min_value("min_specificity", min_specificity)


def _multilabel_sensitivity_at_specificity_compute(
    state: CurveState, num_labels: int, thresholds: Optional[Tensor], ignore_index: Optional[int], min_specificity: float
) -> Tuple[Tensor, Tensor]:
    """Per-label ROC -> per-label (sensitivity, threshold)."""
    curves = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _roc_points(curves, lambda sens, spec, thr: _sensitivity_at_specificity(sens, spec, thr, min_specificity))


def multilabel_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_specificity: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest sensitivity at minimum specificity, multilabel."""
    return _multilabel_curve_point(
        preds, target, num_labels, thresholds, ignore_index, validate_args,
        lambda: _multilabel_sensitivity_at_specificity_arg_validation(num_labels, min_specificity, thresholds, ignore_index),
        lambda state, thr: _multilabel_sensitivity_at_specificity_compute(state, num_labels, thr, ignore_index, min_specificity),
    )


def sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_specificity: float,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching sensitivity at fixed specificity."""
    return _literal_task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_sensitivity_at_specificity(preds, target, min_specificity, thresholds, ignore_index, validate_args),
        lambda: multiclass_sensitivity_at_specificity(
            preds, target, num_classes, min_specificity, thresholds, ignore_index, validate_args
        ),
        lambda: multilabel_sensitivity_at_specificity(
            preds, target, num_labels, min_specificity, thresholds, ignore_index, validate_args
        ),
    )
