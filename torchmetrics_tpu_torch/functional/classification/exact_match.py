# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Exact match (counterpart of ``torchmetrics_tpu/functional/classification/exact_match.py``).

Plain tensor ops: a sample counts when every one of its entries matches.
``correct`` and ``total`` are int32, as in JAX; a samplewise multiclass
``correct`` is the per-sample bool, as there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoBinary

Tensor = torch.Tensor
_I32 = torch.int32


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    """``correct / total``."""
    return _safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Samples whose every entry matches (ignored entries match), and the samples counted."""
    if ignore_index is not None:
        preds = torch.where(target == ignore_index, torch.full_like(preds, ignore_index), preds)
    correct = (preds == target).sum(1, dtype=_I32) == preds.shape[1]
    correct = correct if multidim_average == "samplewise" else correct.sum(dtype=_I32)
    total = torch.tensor(preds.shape[0] if multidim_average == "global" else 1, dtype=_I32, device=preds.device)
    return correct, total


def multiclass_exact_match(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass exact match."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, 1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: Tensor, target: Tensor, num_labels: int, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor]:
    """Samples whose every label matches, and the samples counted."""
    if multidim_average == "global":
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
        target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    correct = ((preds == target).sum(1, dtype=_I32) == num_labels).sum(dim=-1, dtype=_I32)
    total = torch.tensor(preds.shape[0 if multidim_average == "global" else 2], dtype=_I32, device=preds.device)
    return correct, total


def _multilabel_exact_match_format(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """The stat scores' multilabel format, with ignored entries made to match."""
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    if ignore_index is not None:
        preds = torch.where(target == -1, torch.full_like(preds, -1), preds)
    return preds, target


def multilabel_exact_match(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel exact match."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_exact_match_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, num_labels, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching exact match (multiclass and multilabel)."""
    task_enum = ClassificationTaskNoBinary.from_str(task)
    if task_enum == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if task_enum == ClassificationTaskNoBinary.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
