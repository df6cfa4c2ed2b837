# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ROC curves, binned mode (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``)."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ThresholdsArg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _require_binned,
    _uniform_grid,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _binary_roc_compute(state: Tensor, thresholds: Optional[Tensor], pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """fpr/tpr/thresholds from the binned state."""
    _require_binned(thresholds)
    tps = state[:, 1, 1]
    fps = state[:, 0, 1]
    fns = state[:, 1, 0]
    tns = state[:, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), (0,))
    fpr = torch.flip(_safe_divide(fps, fps + tns), (0,))
    return fpr, tpr, torch.flip(thresholds, (0,))


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binary ROC curve (binned)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending = isinstance(thresholds, int)  # the linspace grid
    affine = _uniform_grid(thresholds) if ascending else None
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binary_roc_compute(state, thresholds)


def _multiclass_roc_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Per-class ROC curves from the binned state (``average`` None or ``"micro"``)."""
    if average == "micro":
        return _binary_roc_compute(state, thresholds, pos_label=1)
    _require_binned(thresholds)
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), (0,)).T
    fpr = torch.flip(_safe_divide(fps, fps + tns), (0,)).T
    if average == "macro":
        raise NotImplementedError("average='macro' ROC curve merging is not ported yet (ROADMAP A4b)")
    return fpr, tpr, torch.flip(thresholds, (0,))


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: ThresholdsArg = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Multiclass ROC curves (binned)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending = isinstance(thresholds, int)  # the linspace grid
    affine = _uniform_grid(thresholds) if ascending else None
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average, ascending, affine)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)
