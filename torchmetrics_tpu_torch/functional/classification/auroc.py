# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""AUROC, binned and exact (counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``).

The exact AUROC (``thresholds=None``, no ``max_fpr``) integrates the padded
unique-threshold curve on the device, as JAX does; the classes of a
multiclass metric, or the labels of a multilabel one, share one batched
stable sort of the ``(C, M)`` transpose."""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    ThresholdsArg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _clf_curve_padded_rows,
    _grid_hints,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utilities.checks import _is_concrete
from torchmetrics_tpu_torch.utilities.compute import _auc_compute_without_check, _safe_divide
from torchmetrics_tpu_torch.utilities.data import _bincount, _float32_inputs, _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _reduce_auroc_values(res: Tensor, average: Optional[str], weights: Optional[Tensor] = None) -> Tensor:
    """Reduce per-class AUC values; NaN classes are left out with a warning.

    The NaN check reads one value back to the host, once per compute.
    """
    if average is None or average == "none":
        return res
    if _is_concrete(res) and bool(torch.isnan(res).any()):
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


def _binary_auroc_compute(state: CurveState, thresholds: Optional[Tensor], max_fpr: Optional[float] = None, pos_label: int = 1) -> Tensor:
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


def _previous_group_end(values: Tensor, mask: Tensor) -> Tensor:
    """At each position of the rows, ``values`` at the last masked position before
    it (0 before the first): a shifted running maximum of the masked values,
    which ascend along a curve."""
    ends = torch.where(mask, values, torch.zeros_like(values))
    running = torch.cummax(ends, dim=-1).values
    return torch.cat([torch.zeros_like(running[..., :1]), running[..., :-1]], -1)


def _auroc_exact_rows(preds: Tensor, target: Tensor, pos_label: Union[int, Tensor] = 1) -> Tensor:
    """Exact AUROC of every row of ``preds`` (R, N), on the device, static shapes.

    Trapezoids over the padded curve of :func:`_clf_curve_padded_rows`:
    ``sum_g (tp_g + tp_prev) / 2 * (fp_g - fp_prev) / (P * N)`` over the tie
    groups, the Mann-Whitney midrank statistic. float32 products, as in JAX.
    ``target`` and ``pos_label`` as there; a row without positives or
    negatives gives 0.
    """
    if preds.shape[-1] == 0:
        return torch.zeros(preds.shape[:-1], dtype=torch.float32, device=preds.device)
    fps, tps, _, mask = _clf_curve_padded_rows(preds, target, pos_label)
    prev_tps = _previous_group_end(tps, mask).to(torch.float32)
    prev_fps = _previous_group_end(fps, mask).to(torch.float32)
    tps_f, fps_f = tps.to(torch.float32), fps.to(torch.float32)
    area = torch.where(mask, 0.5 * (tps_f + prev_tps) * (fps_f - prev_fps), torch.zeros_like(tps_f)).sum(-1)
    n_pos, n_neg = tps_f[..., -1], fps_f[..., -1]
    return torch.where((n_pos > 0) & (n_neg > 0), area / torch.clamp(n_pos * n_neg, min=1.0), torch.zeros_like(area))


def _binary_auroc_exact_device(preds: Tensor, target: Tensor) -> Tensor:
    """Exact (unbinned) AUROC on the device: the rank statistic of the padded
    curve; entries with ``target < 0`` carry no weight."""
    return _auroc_exact_rows(_float32_inputs(preds).reshape(1, -1), target.reshape(1, -1))[0]


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary AUROC (binned, or exact: the rank statistic on the device)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and max_fpr is None:
        return _binary_auroc_exact_device(preds, target)
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


def _multiclass_auroc_exact_device(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """Per-class exact AUROC, one-vs-rest, on the device: one stable sort of the
    ``(C, M)`` transpose of ``preds`` (M, C) for every class at once. ``target``
    (M,) uses -1 for ignored samples."""
    classes = torch.arange(num_classes, device=preds.device, dtype=target.dtype)[:, None]
    return _auroc_exact_rows(preds.T, target, classes)


def _class_support(target: Tensor, num_classes: int) -> Tensor:
    """float32 count of each class among the valid targets (the weights of ``average="weighted"``)."""
    return _bincount(torch.where(target >= 0, target, torch.full_like(target, num_classes)), num_classes).to(torch.float32)


def _multiclass_auroc_compute(
    state: CurveState,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """Per-class AUROC from the binned state or the exact stream, then the reduction."""
    if thresholds is None and isinstance(state, tuple):
        preds, target = state
        res = _multiclass_auroc_exact_device(preds, target, num_classes)
        return _reduce_auroc_values(res, average, weights=_class_support(target, num_classes))
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
    """Multiclass AUROC."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds, ignore_index)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, ascending=ascending, affine=affine)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


def _multilabel_auroc_exact_device(preds: Tensor, target: Tensor) -> Tensor:
    """Per-label exact AUROC on the device: one stable sort of the ``(L, M)``
    transposes; -1 entries carry no weight."""
    return _auroc_exact_rows(preds.T, target.T)


def _multilabel_auroc_compute(
    state: CurveState,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Per-label AUROC (or micro: of the flattened stream), then the reduction."""
    if average == "micro":
        if thresholds is None and isinstance(state, tuple):
            return _binary_auroc_exact_device(state[0].reshape(-1), state[1].reshape(-1))
        return _binary_auroc_compute(state.sum(1, dtype=state.dtype), thresholds, max_fpr=None)
    if thresholds is None and isinstance(state, tuple):
        preds, target = state
        res = _multilabel_auroc_exact_device(preds, target)
        return _reduce_auroc_values(res, average, weights=(target == 1).sum(0, dtype=torch.int32).to(torch.float32))
    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    weights = state[0, :, 1, :].sum(-1).to(torch.float32)
    return _reduce_auroc(fpr, tpr, average, weights=weights)


def _multilabel_auroc_arg_validation(
    num_labels: int, average: Optional[str], thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def multilabel_auroc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel AUROC."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ascending, affine)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching AUROC."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args),
        lambda: multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args),
        lambda: multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args),
    )
