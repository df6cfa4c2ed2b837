# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Precision at fixed recall (counterpart of
``torchmetrics_tpu/functional/classification/precision_fixed_recall.py``):
recall at fixed precision's curve and selection with the roles swapped."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import ThresholdsArg
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_curve_point,
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _lex_best_at_constraint_device,
    _multiclass_curve_point,
    _multiclass_recall_at_fixed_precision_arg_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_curve_point,
    _multilabel_recall_at_fixed_precision_arg_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
)
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


def _precision_at_recall(precision: Tensor, recall: Tensor, thresholds: Tensor, min_recall: float) -> Tuple[Tensor, Tensor]:
    """Max precision whose recall >= min_recall, on the device."""
    return _lex_best_at_constraint_device(precision, recall, thresholds, min_recall)


def binary_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    min_recall: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest precision at minimum recall, binary."""
    return _binary_curve_point(
        preds, target, thresholds, ignore_index, validate_args,
        lambda: _binary_recall_at_fixed_precision_arg_validation(min_recall, thresholds, ignore_index),
        lambda state, thr: _binary_recall_at_fixed_precision_compute(state, thr, min_recall, reduce_fn=_precision_at_recall),
    )


def multiclass_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest precision at minimum recall, multiclass."""
    return _multiclass_curve_point(
        preds, target, num_classes, thresholds, ignore_index, validate_args,
        lambda: _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_recall, thresholds, ignore_index),
        lambda state, thr: _multiclass_recall_at_fixed_precision_arg_compute(
            state, num_classes, thr, min_recall, reduce_fn=_precision_at_recall
        ),
    )


def multilabel_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest precision at minimum recall, multilabel."""
    return _multilabel_curve_point(
        preds, target, num_labels, thresholds, ignore_index, validate_args,
        lambda: _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_recall, thresholds, ignore_index),
        lambda state, thr: _multilabel_recall_at_fixed_precision_arg_compute(
            state, num_labels, thr, ignore_index, min_recall, reduce_fn=_precision_at_recall
        ),
    )


def precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_recall: float,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching precision at fixed recall."""
    return _literal_task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_precision_at_fixed_recall(preds, target, min_recall, thresholds, ignore_index, validate_args),
        lambda: multiclass_precision_at_fixed_recall(preds, target, num_classes, min_recall, thresholds, ignore_index, validate_args),
        lambda: multilabel_precision_at_fixed_recall(preds, target, num_labels, min_recall, thresholds, ignore_index, validate_args),
    )
