# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Multilabel ranking metrics (counterpart of
``torchmetrics_tpu/functional/classification/ranking.py``): coverage error,
label-ranking average precision and ranking loss.

Each update returns a float32 sum over the batch's rows and the row count
(int32), as in JAX. Coverage error offsets every irrelevant score by the
whole batch's ``|min| + 10``. Label-ranking AP compares every pair of
labels of a row in an ``(N, C, C)`` bool tensor, counts exactly and divides
in float32. The ranking loss takes the inverse ranks of a stable sort, in
JAX's order: a stable sort of integer codes of the scores
(:func:`_sort_codes`), where ``-0`` ties ``+0`` and every NaN ties at the
top, then the stable inverse permutation, on the CPU and the card alike.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _multilabel_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _sort_codes
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor
_I32 = torch.int32


def _ranking_reduce(score: Tensor, num_elements: Tensor) -> Tensor:
    """Mean over samples."""
    return score / num_elements


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    """Validate input tensors (reads values back to the host, unless capturing)."""
    _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            f"Expected preds tensor to be floating point, but received input with dtype {str(preds.dtype).replace('torch.', '')}"
        )


def _multilabel_ranking_format(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """``(M, L)`` float32 scores (sigmoid where some value lies outside [0, 1]);
    ``ignore_index`` targets become 0 (not relevant)."""
    if preds.ndim > 2:
        preds = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
        target = torch.movedim(target, 1, -1).reshape(-1, target.shape[1])
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid")
    if ignore_index is not None:
        target = torch.where(target == ignore_index, 0, target)
    return preds, target


def _row_count(x: Tensor) -> Tensor:
    """``jnp.asarray(n)`` of a count ``n`` on ``x``'s device: an int32 0-d tensor, made by a fill."""
    return torch.full((), x.shape[0], dtype=_I32, device=x.device)


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Summed coverage and the row count."""
    offset = torch.where(target == 0, torch.abs(preds.min()) + 10, 0.0)
    preds_min = (preds + offset).amin(1)
    coverage = (preds >= preds_min[:, None]).sum(1, dtype=_I32).to(torch.float32)
    return coverage.sum(), _row_count(coverage)


def multilabel_coverage_error(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel coverage error."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, ignore_index)
    coverage, total = _multilabel_coverage_error_update(preds, target)
    return _ranking_reduce(coverage, total)


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Summed label-ranking AP and the row count.

    For a row with relevant set R: the mean over j in R of
    #{relevant k: s_k >= s_j} / #{k: s_k >= s_j}. A row with no relevant
    label, or with every label relevant, scores 1.
    """
    neg = -preds
    num_labels = preds.shape[1]
    relevant = target == 1
    le = neg[:, None, :] <= neg[:, :, None]  # le[i, j, k]: label k ranks at or above label j
    rank_all = le.sum(2, dtype=_I32).to(torch.float32)
    rank_rel = (le & relevant[:, None, :]).sum(2, dtype=_I32).to(torch.float32)
    n_rel = relevant.sum(1, dtype=_I32)
    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    score_row = torch.where(n_rel > 0, per_label.sum(1) / n_rel.clamp(min=1), 1.0)
    score_row = torch.where((n_rel > 0) & (n_rel < num_labels), score_row, 1.0)
    return score_row.sum(), _row_count(preds)


def multilabel_ranking_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel ranking average precision."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, ignore_index)
    score, total = _multilabel_ranking_average_precision_update(preds, target)
    return _ranking_reduce(score, total)


def _inverse_ranks(preds: Tensor) -> Tensor:
    """``jnp.argsort(jnp.argsort(preds, axis=1), axis=1)``: each score's rank in
    its row, ties in input order."""
    order = torch.argsort(_sort_codes(preds), dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Summed ranking loss and the row count."""
    num_labels = preds.shape[1]
    relevant = target == 1
    num_relevant = relevant.sum(1, dtype=_I32)
    valid = (num_relevant > 0) & (num_relevant < num_labels)
    per_label_loss = ((num_labels - _inverse_ranks(preds)) * relevant).to(torch.float32)
    correction = 0.5 * num_relevant * (num_relevant + 1)
    denom = num_relevant * (num_labels - num_relevant)
    loss = (per_label_loss.sum(1) - correction) / denom.clamp(min=1)
    return torch.where(valid, loss, 0.0).sum(), _row_count(preds)


def multilabel_ranking_loss(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel ranking loss."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, ignore_index)
    loss, total = _multilabel_ranking_loss_update(preds, target)
    return _ranking_reduce(loss, total)
