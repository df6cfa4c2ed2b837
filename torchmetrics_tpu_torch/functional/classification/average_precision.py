# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Average precision, binned and exact (counterpart of
``torchmetrics_tpu/functional/classification/average_precision.py``).

The exact AP (``thresholds=None``) sums ``delta TP * precision`` over the tie
groups of the padded unique-threshold curve on the device, as JAX does; the
classes or labels of one metric share one batched stable sort."""
from __future__ import annotations

from typing import List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.classification.auroc import (
    _class_support,
    _multiclass_auroc_arg_validation,
    _multilabel_auroc_arg_validation,
    _previous_group_end,
    _reduce_auroc_values,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    ThresholdsArg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _clf_curve_padded_rows,
    _grid_hints,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _float32_inputs, _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


def _average_precision_exact_rows(preds: Tensor, target: Tensor, pos_label: Union[int, Tensor] = 1) -> Tensor:
    """Exact AP of every row of ``preds`` (R, N), on the device, static shapes.

    ``AP = sum_g (TP_g - TP_prev) * precision_g / P`` over the tie groups of
    the padded curve (:func:`_clf_curve_padded_rows`, ``target`` and
    ``pos_label`` as there), the previous group's TP from a shifted running
    maximum; float32, as in JAX. A row without positives gives 0.
    """
    if preds.shape[-1] == 0:
        return torch.zeros(preds.shape[:-1], dtype=torch.float32, device=preds.device)
    fps, tps, _, mask = _clf_curve_padded_rows(preds, target, pos_label)
    delta_tp = torch.where(mask, tps - _previous_group_end(tps, mask), torch.zeros_like(tps)).to(torch.float32)
    precision = _safe_divide(tps.to(torch.float32), (tps + fps).to(torch.float32))
    n_pos = tps[..., -1].to(torch.float32)
    ap = (delta_tp * precision).sum(-1) / torch.clamp(n_pos, min=1.0)
    return torch.where(n_pos > 0, ap, torch.zeros_like(ap))


def _binary_average_precision_exact_device(preds: Tensor, target: Tensor, pos_label: int = 1) -> Tensor:
    """Exact (unbinned) average precision on the device; entries with ``target < 0`` carry no weight."""
    return _average_precision_exact_rows(_float32_inputs(preds).reshape(1, -1), target.reshape(1, -1), pos_label)[0]


def _reduce_average_precision(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """AP = -sum(diff(recall) * precision[:-1]) per class, then the reduction
    (NaN classes left out with a warning, a host read once per compute)."""
    if isinstance(precision, Tensor):
        res = -torch.sum(torch.diff(recall, dim=1) * precision[:, :-1], dim=1)
    else:
        res = torch.stack([-torch.sum(torch.diff(r) * p[:-1]) for p, r in zip(precision, recall)])
    return _reduce_auroc_values(res, average, weights)


def _binary_average_precision_compute(state: CurveState, thresholds: Optional[Tensor], pos_label: int = 1) -> Tensor:
    """Binary AP from the binned curve, or exact on the device."""
    if thresholds is None and isinstance(state, tuple):
        return _binary_average_precision_exact_device(state[0], state[1], pos_label)
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return -torch.sum(torch.diff(recall) * precision[:-1])


def binary_average_precision(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary average precision."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binary_average_precision_compute(state, thresholds)


_multiclass_average_precision_arg_validation = _multiclass_auroc_arg_validation


def _multiclass_average_precision_compute(
    state: CurveState,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """Per-class AP (exact: one-vs-rest, one batched sort), then the reduction."""
    if thresholds is None and isinstance(state, tuple):
        preds, target = state
        classes = torch.arange(num_classes, device=preds.device, dtype=target.dtype)[:, None]
        res = _average_precision_exact_rows(preds.T, target, classes)
        return _reduce_auroc_values(res, average, weights=_class_support(target, num_classes))
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    weights = state[0, :, 1, :].sum(-1).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights=weights)


def multiclass_average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass average precision."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds, ignore_index)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, ascending=ascending, affine=affine)
    return _multiclass_average_precision_compute(state, num_classes, average, thresholds)


def _multilabel_average_precision_compute(
    state: CurveState,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Per-label AP (or micro: of the flattened stream), then the reduction."""
    if average == "micro":
        if thresholds is None and isinstance(state, tuple):
            return _binary_average_precision_exact_device(state[0].reshape(-1), state[1].reshape(-1))
        return _binary_average_precision_compute(state.sum(1, dtype=state.dtype), thresholds)
    if thresholds is None and isinstance(state, tuple):
        preds, target = state
        res = _average_precision_exact_rows(preds.T, target.T)
        return _reduce_auroc_values(res, average, weights=(target == 1).sum(0, dtype=torch.int32).to(torch.float32))
    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    weights = state[0, :, 1, :].sum(-1).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights=weights)


def multilabel_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel average precision."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ascending, affine)
    return _multilabel_average_precision_compute(state, num_labels, average, thresholds, ignore_index)


def average_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching average precision."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_average_precision(preds, target, thresholds, ignore_index, validate_args),
        lambda: multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index, validate_args),
        lambda: multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args),
    )
