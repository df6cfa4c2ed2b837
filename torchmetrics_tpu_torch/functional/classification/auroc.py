# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""AUROC, binned mode (counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``)."""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
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
    _uniform_grid,
)
from torchmetrics_tpu_torch.functional.classification.roc import _binary_roc_compute, _multiclass_roc_compute
from torchmetrics_tpu_torch.utilities.compute import _auc_compute_without_check, _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _reduce_auroc_values(res: Tensor, average: Optional[str], weights: Optional[Tensor] = None) -> Tensor:
    """Reduce per-class AUC values; NaN classes are left out with a warning.

    The NaN check reads one value back to the host, once per compute.
    """
    if average is None or average == "none":
        return res
    if bool(torch.isnan(res).any()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    idx = ~torch.isnan(res)
    zeros = torch.zeros_like(res)
    if average == "macro":
        return torch.where(idx, res, zeros).sum() / idx.sum()
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights, torch.zeros_like(weights))
        weights = _safe_divide(weights, weights.sum())
        return (torch.where(idx, res, zeros) * weights).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _reduce_auroc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
    direction: float = 1.0,
) -> Tensor:
    """Per-class AUCs of stacked (C, T) or listed curves, then their reduction."""
    if isinstance(fpr, Tensor):
        res = _auc_compute_without_check(fpr, tpr, direction=direction, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, direction=direction) for x, y in zip(fpr, tpr)])
    return _reduce_auroc_values(res, average, weights)


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if max_fpr is not None and not isinstance(max_fpr, float) and 0 < max_fpr <= 1:
        raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")


def _binary_auroc_compute(state: Tensor, thresholds: Optional[Tensor], max_fpr: Optional[float] = None, pos_label: int = 1) -> Tensor:
    """AUROC with the optional McClish partial-AUC correction.

    The ``max_fpr`` branch interpolates one point on the host, as the JAX
    package does.
    """
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None or max_fpr == 1 or bool(fpr.sum() == 0) or bool(tpr.sum() == 0):
        return _auc_compute_without_check(fpr, tpr, 1.0)
    max_area = float(np.float32(max_fpr))
    fpr_np, tpr_np = fpr.cpu().numpy(), tpr.cpu().numpy()
    stop = int(np.searchsorted(fpr_np, max_area, side="right"))
    weight = (max_area - fpr_np[stop - 1]) / (fpr_np[stop] - fpr_np[stop - 1])
    interp_tpr = tpr_np[stop - 1] + weight * (tpr_np[stop] - tpr_np[stop - 1])
    tpr2 = torch.tensor(np.concatenate([tpr_np[:stop], [interp_tpr]]).astype(np.float32), device=fpr.device)
    fpr2 = torch.tensor(np.concatenate([fpr_np[:stop], [max_area]]).astype(np.float32), device=fpr.device)
    partial_auc = _auc_compute_without_check(fpr2, tpr2, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary AUROC (binned)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending = isinstance(thresholds, int)  # the linspace grid
    affine = _uniform_grid(thresholds) if ascending else None
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _multiclass_auroc_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    allowed_average = ("macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def _multiclass_auroc_compute(
    state: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """Per-class AUROC from the binned state, then the reduction."""
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    # per-class support tp+fn, identical at every threshold -> read slot 0
    weights = state[0, :, 1, :].sum(-1).to(torch.float32)
    return _reduce_auroc(fpr, tpr, average, weights=weights)


def multiclass_auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass AUROC (binned)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending = isinstance(thresholds, int)  # the linspace grid
    affine = _uniform_grid(thresholds) if ascending else None
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds, ignore_index)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, ascending=ascending, affine=affine)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)
