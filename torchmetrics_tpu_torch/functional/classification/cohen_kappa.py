# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Cohen's kappa (counterpart of ``torchmetrics_tpu/functional/classification/cohen_kappa.py``)."""
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
)
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor
_ALLOWED_WEIGHTS = ("linear", "quadratic", "none", None)


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Reduce a confusion matrix into the kappa score, in float32.

    The expected matrix is the outer product of the row and column sums over
    the total. It is written as a broadcast product, not ``sum1 @ sum0``: a
    matmul on the card may run in TF32, and a product with an inner
    dimension of 1 is the elementwise product, as JAX's ``@`` computes it.
    """
    confmat = confmat.to(torch.float32)
    num_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 * sum0 / sum0.sum()

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(num_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(num_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[:, None] - idx[None, :]
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def _binary_cohen_kappa_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, weights: Optional[str] = None
) -> None:
    _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
    if weights not in _ALLOWED_WEIGHTS:
        raise ValueError(f"Expected argument `weight` to be one of {_ALLOWED_WEIGHTS}, but got {weights}.")


def binary_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary Cohen's kappa."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_cohen_kappa_arg_validation(threshold, ignore_index, weights)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _cohen_kappa_reduce(_binary_confusion_matrix_update(preds, target), weights)


def _multiclass_cohen_kappa_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, weights: Optional[str] = None
) -> None:
    _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
    if weights not in _ALLOWED_WEIGHTS:
        raise ValueError(f"Expected argument `weight` to be one of {_ALLOWED_WEIGHTS}, but got {weights}.")


def multiclass_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass Cohen's kappa."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_cohen_kappa_arg_validation(num_classes, ignore_index, weights)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target)
    return _cohen_kappa_reduce(_multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index), weights)


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching Cohen's kappa (binary and multiclass)."""
    task_enum = ClassificationTaskNoMultilabel.from_str(task)
    if task_enum == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if task_enum == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
