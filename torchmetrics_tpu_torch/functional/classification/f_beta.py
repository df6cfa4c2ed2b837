# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""F-beta / F1 (counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _dim_sum, _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

Tensor = torch.Tensor


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    zero_division: float = 0,
) -> Tensor:
    """Reduce stats into f-beta."""
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp, fn, fp = _dim_sum(tp, axis), _dim_sum(fn, axis), _dim_sum(fp, axis)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    fbeta_score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn)


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Binary F-beta."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _validate_beta(beta)
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index, zero_division)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
    return _fbeta_reduce(tp, fp, tn, fn, beta, "binary", multidim_average, zero_division=zero_division)


def multiclass_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Multiclass F-beta."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _validate_beta(beta)
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index, zero_division)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k, average, multidim_average)
    tp, fp, tn, fn = _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average, multidim_average, zero_division=zero_division)


def binary_f1_score(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Binary F1."""
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args, zero_division)


def multiclass_f1_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Multiclass F1."""
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
    )


def multilabel_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Multilabel F-beta."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _validate_beta(beta)
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index, zero_division)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average, multidim_average, multilabel=True, zero_division=zero_division)


def multilabel_f1_score(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Multilabel F1."""
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    task: str,
    beta: float = 1.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Task-dispatching F-beta."""
    task_enum = ClassificationTask.from_str(task)
    if task_enum == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args, zero_division)
    if task_enum == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_fbeta_score(
            preds, target, beta, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
        )
    if task_enum == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_fbeta_score(
            preds, target, beta, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
        )
    raise ValueError(f"Not handled value: {task}")


def f1_score(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Task-dispatching F1."""
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, zero_division,
    )
