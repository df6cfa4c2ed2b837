# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Jaccard index (counterpart of ``torchmetrics_tpu/functional/classification/jaccard.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


def _jaccard_index_reduce(
    confmat: Tensor,
    average: Optional[str],
    ignore_index: Optional[int] = None,
    zero_division: float = 0.0,
) -> Tensor:
    """Reduce an un-normalized confusion matrix into the Jaccard index."""
    allowed_average = ["binary", "micro", "macro", "weighted", "none", None]
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return _safe_divide(confmat[1, 1], confmat[0, 1] + confmat[1, 0] + confmat[1, 1], zero_division=zero_division)

    ignore_index_cond = ignore_index is not None and 0 <= ignore_index < confmat.shape[0]
    multilabel = confmat.ndim == 3
    if multilabel:
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:
        num = torch.diagonal(confmat)
        denom = confmat.sum(0) + confmat.sum(1) - num

    if average == "micro":
        num = num.sum()
        denom = denom.sum() - (denom[ignore_index] if ignore_index_cond else 0.0)

    jaccard = _safe_divide(num, denom, zero_division=zero_division)
    if average is None or average in ("none", "micro"):
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if multilabel else confmat.sum(1)
    else:
        weights = torch.ones_like(jaccard)
        if ignore_index_cond:
            weights[ignore_index] = 0.0
        if not multilabel:
            weights = torch.where(confmat.sum(1) + confmat.sum(0) == 0, torch.zeros_like(weights), weights)
    return ((weights * jaccard) / weights.sum()).sum()


def binary_jaccard_index(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Binary Jaccard index."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _jaccard_index_reduce(confmat, average="binary", zero_division=zero_division)


def multiclass_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Multiclass Jaccard index."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index, zero_division=zero_division)


def multilabel_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Multilabel Jaccard index."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _jaccard_index_reduce(confmat, average=average, zero_division=zero_division)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Task-dispatching Jaccard index."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_jaccard_index(preds, target, threshold, ignore_index, validate_args, zero_division),
        lambda: multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args, zero_division),
        lambda: multilabel_jaccard_index(
            preds, target, num_labels, threshold, average, ignore_index, validate_args, zero_division
        ),
    )
