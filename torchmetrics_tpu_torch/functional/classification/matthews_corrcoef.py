# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Matthews correlation coefficient (counterpart of
``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``)."""
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
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """Reduce a confusion matrix into the MCC, in float32.

    A binary matrix whose denominator vanishes takes the special values of
    the JAX function (which chooses them with ``where``, so nothing is read
    back to the host): 1 when every entry is right, -1 when every one is
    wrong, otherwise an eps-regularised ratio.
    """
    confmat = confmat.sum(0) if confmat.ndim == 3 else confmat  # multilabel: one binary matrix
    confmat = confmat.to(torch.float32)

    tk = confmat.sum(dim=-1)
    pk = confmat.sum(dim=-2)
    c = torch.trace(confmat)
    s = confmat.sum()

    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()

    numerator = cov_ytyp
    denom = cov_ypyp * cov_ytyt

    if confmat.numel() == 4:
        tn, fp, fn, tp = confmat.reshape(-1)
        eps = torch.tensor(torch.finfo(torch.float32).eps, dtype=torch.float32, device=confmat.device)
        # (a, b) by the margin that collapsed
        a = torch.where(
            (fn == 0) & (tn == 0), tp, torch.where((fp == 0) & (tn == 0), tp, torch.where((tp == 0) & (fn == 0), tn, tn))
        )
        b = torch.where(
            (fn == 0) & (tn == 0), fp, torch.where((fp == 0) & (tn == 0), fn, torch.where((tp == 0) & (fn == 0), fp, fn))
        )
        eps_numerator = torch.sqrt(eps) * (a - b)
        eps_denom = (tp + fp + eps) * (tp + fn + eps) * (tn + fp + eps) * (tn + fn + eps)
        numerator = torch.where(denom == 0, eps_numerator, numerator)
        denom = torch.where(denom == 0, eps_denom, denom)
        res = numerator / torch.sqrt(denom)
        one = torch.ones_like(res)
        res = torch.where((tp + tn != 0) & (fp + fn == 0), one, res)
        return torch.where((tp + tn == 0) & (fp + fn != 0), -one, res)
    safe_denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where(denom == 0, torch.zeros_like(denom), numerator / torch.sqrt(safe_denom))


def binary_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary MCC."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_binary_confusion_matrix_update(preds, target))


def multiclass_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass MCC."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target)
    return _matthews_corrcoef_reduce(_multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index))


def multilabel_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel MCC (of the labels' summed binary matrices)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_multilabel_confusion_matrix_update(preds, target, num_labels))


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching MCC."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args),
        lambda: multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args),
        lambda: multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args),
    )
