# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ROC curves, binned and exact (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``)."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    ThresholdsArg,
    _binary_clf_curve_host,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _exact_stream,
    _grid_hints,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _per_column_curves,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, interp
from torchmetrics_tpu_torch.utilities.data import _float32_inputs, _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor
Curves = Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]


def _binned_rates(state: Tensor) -> Tuple[Tensor, Tensor]:
    """fpr and tpr at every threshold of a binned ``(T, ..., 2, 2)`` state, highest threshold first."""
    tps = state[..., 1, 1]
    fps = state[..., 0, 1]
    fns = state[..., 1, 0]
    tns = state[..., 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), (0,))
    fpr = torch.flip(_safe_divide(fps, fps + tns), (0,))
    return fpr, tpr


def _binary_roc_compute(state: CurveState, thresholds: Optional[Tensor], pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """fpr/tpr/thresholds from the binned state, or from the exact stream.

    The exact curve starts at the origin (threshold 1). Its rates are the
    int counts divided in float64 and rounded to float32 once, as the JAX
    package's NumPy division does; its thresholds are float32, as JAX
    returns them with 64-bit types off.
    """
    if thresholds is not None and not isinstance(state, tuple):
        fpr, tpr = _binned_rates(state)
        return fpr, tpr, torch.flip(thresholds, (0,))
    fps, tps, thres = _binary_clf_curve_host(*_exact_stream(state), pos_label=pos_label)
    origin = torch.zeros(1, dtype=torch.float64, device=thres.device)
    tps = torch.cat([origin, tps.to(torch.float64)])
    fps = torch.cat([origin, fps.to(torch.float64)])
    thres = torch.cat([torch.ones(1, dtype=thres.dtype, device=thres.device), thres])
    if bool(fps[-1] <= 0):
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros_like(thres)
    else:
        fpr = fps / fps[-1]
    if bool(tps[-1] <= 0):
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros_like(thres)
    else:
        tpr = tps / tps[-1]
    return fpr.to(torch.float32), tpr.to(torch.float32), _float32_inputs(thres)


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binary ROC curve."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binary_roc_compute(state, thresholds)


def _macro_roc(fpr_list: List[Tensor], tpr_list: List[Tensor], thres_list: List[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """The per-class curves merged onto the union fpr axis: each tpr
    interpolated there (:func:`interp`, ``jnp.interp``'s semantics) and averaged."""
    thres = torch.flip(torch.sort(torch.cat(thres_list), stable=True).values, (0,))
    mean_fpr = torch.sort(torch.cat(fpr_list), stable=True).values
    mean_tpr = torch.zeros_like(mean_fpr)
    for fpr, tpr in zip(fpr_list, tpr_list):
        mean_tpr = mean_tpr + interp(mean_fpr, fpr, tpr)
    return mean_fpr, mean_tpr / len(fpr_list), thres


def _multiclass_roc_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Curves:
    """Per-class ROC curves (binned: stacked; exact: lists), or their micro or macro merge."""
    if average == "micro":
        return _binary_roc_compute(state, thresholds, pos_label=1)
    if thresholds is not None and not isinstance(state, tuple):
        fpr, tpr = _binned_rates(state)
        fpr, tpr, thres = fpr.T, tpr.T, torch.flip(thresholds, (0,))
        if average == "macro":
            return _macro_roc(list(fpr), list(tpr), [thres] * num_classes)
        return fpr, tpr, thres
    fpr_list, tpr_list, thres_list = _per_column_curves(_binary_roc_compute, *_exact_stream(state), range(num_classes))
    if average == "macro":
        return _macro_roc(fpr_list, tpr_list, thres_list)
    return fpr_list, tpr_list, thres_list


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: ThresholdsArg = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Multiclass ROC curves."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average, ascending, affine)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)


def _multilabel_roc_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Curves:
    """Per-label ROC curves (binned: stacked; exact: lists, each label's ignored entries dropped)."""
    if thresholds is not None and not isinstance(state, tuple):
        fpr, tpr = _binned_rates(state)
        return fpr.T, tpr.T, torch.flip(thresholds, (0,))
    return _per_column_curves(_binary_roc_compute, *state, [1] * num_labels)


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Multilabel ROC curves."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ascending, affine)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching ROC."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_roc(preds, target, thresholds, ignore_index, validate_args),
        lambda: multiclass_roc(preds, target, num_classes, thresholds, average, ignore_index, validate_args),
        lambda: multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args),
    )
