# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Hinge loss (counterpart of ``torchmetrics_tpu/functional/classification/hinge.py``).

The summed measure is float32 (a 0-d tensor, or ``(C,)`` one-vs-all) and the
count an int32 0-d tensor, the JAX package's dtypes. Ignored positions carry
the target -1 and add nothing; a label outside ``[0, C)`` one-hots to a row
of zeros, as ``jax.nn.one_hot`` makes it. Elementwise work and column sums
only: no host read, so a CUDA graph captures the update.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.calibration_error import _check_float_preds
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _to_tensors, to_onehot
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    """Mean hinge loss."""
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    """Validate non-tensor args."""
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    """Validate input tensors (reads values back to the host, unless capturing)."""
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    _check_float_preds(preds)


def _hinge(margin: Tensor, squared: bool) -> Tensor:
    measures = torch.clamp(1 - margin, min=0)
    return measures * measures if squared else measures


def _binary_hinge_loss_format(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Flat float32 margins in [0, 1] (sigmoid where some value lies outside); ignored targets become -1."""
    preds = normalize_logits_if_needed(preds.reshape(-1).to(torch.float32), "sigmoid")
    target = target.reshape(-1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _binary_hinge_loss_update(preds: Tensor, target: Tensor, squared: bool) -> Tuple[Tensor, Tensor]:
    """Summed hinge measure and the count of valid positions."""
    valid = target >= 0
    sign = torch.where(target > 0, 1.0, -1.0)
    measures = torch.where(valid, _hinge(sign * preds, squared), 0.0)
    return measures.sum(0), valid.sum(dtype=torch.int32)


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary hinge loss."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_hinge_loss_format(preds, target, ignore_index)
    measures, total = _binary_hinge_loss_update(preds, target, squared)
    return _hinge_loss_compute(measures, total)


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    """Validate non-tensor args."""
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    allowed_mm = ("crammer-singer", "one-vs-all")
    if multiclass_mode not in allowed_mm:
        raise ValueError(f"Expected argument `multiclass_mode` to be one of {allowed_mm}, but got {multiclass_mode}.")


def _multiclass_hinge_loss_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate input tensors (reads values back to the host, unless capturing)."""
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    _check_float_preds(preds)


def _multiclass_hinge_loss_format(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """``(M, C)`` float32 scores and flat targets; ignored targets become -1."""
    if preds.ndim > 2:
        preds = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
        target = target.reshape(-1)
    preds = preds.to(torch.float32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multiclass_hinge_loss_update(
    preds: Tensor, target: Tensor, squared: bool, multiclass_mode: str = "crammer-singer"
) -> Tuple[Tensor, Tensor]:
    """Summed hinge measures (0-d for Crammer-Singer, ``(C,)`` one-vs-all) and the count of valid rows."""
    preds = normalize_logits_if_needed(preds, "softmax")
    valid = target >= 0
    target_oh = to_onehot(torch.where(valid, target, 0), max(2, preds.shape[1])).to(torch.bool)
    total = valid.sum(dtype=torch.int32)
    if multiclass_mode == "crammer-singer":
        true_score = torch.where(target_oh, preds, 0.0).sum(1)
        best_other = torch.where(target_oh, float("-inf"), preds).amax(1)
        measures = torch.where(valid, _hinge(true_score - best_other, squared), 0.0)
        return measures.sum(0), total
    margin = torch.where(target_oh, preds, -preds)
    measures = torch.where(valid[:, None], _hinge(margin, squared), 0.0)
    return measures.sum(0), total


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass hinge loss."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_hinge_loss_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_hinge_loss_format(preds, target, ignore_index)
    measures, total = _multiclass_hinge_loss_update(preds, target, squared, multiclass_mode)
    return _hinge_loss_compute(measures, total)


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching hinge loss."""
    return _literal_task_call(
        task,
        num_classes,
        None,
        lambda: binary_hinge_loss(preds, target, squared, ignore_index, validate_args),
        lambda: multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args),
    )
