# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Recall at fixed precision (counterpart of
``torchmetrics_tpu/functional/classification/recall_fixed_precision.py``).

The curve is the precision-recall curve's (binned: kernel K1's state;
exact: the unique-threshold curve), and the constrained selection runs on
the tensors' device as masked maxima: the highest primary value among the
points that meet the constraint, ties broken by the constraint, then by
the threshold, then by the first point, the order of the reference's
``_lexargmax``. Each step is a compare, a mask, a maximum or one
``torch.argmax`` (the first maximum, as ``jnp.argmax``), so the chosen
value and threshold are JAX's bit for bit. The JAX package selects class by
class in a Python loop; here a binned state's classes or labels are rows
of one selection.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    ThresholdsArg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _grid_hints,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor
Selection = Callable[[Tensor, Tensor, Tensor, float], Tuple[Tensor, Tensor]]


def _constrained_rows(primary: Tensor, constraint: Tensor, thresholds: Tensor, min_constraint: float):
    """The three curves cut to their common length along the last axis, the
    thresholds broadcast to the others' rows, and the mask of the points that
    meet the constraint. ``min_constraint`` is compared in float32, as JAX
    promotes a Python scalar against a float32 array."""
    n = min(primary.shape[-1], constraint.shape[-1], thresholds.shape[-1])
    primary, constraint = primary[..., :n], constraint[..., :n]
    thresholds = thresholds[..., :n].expand(primary.shape)
    return primary, constraint, thresholds, constraint >= float(np.float32(min_constraint))


def _lex_best_at_constraint_device(
    primary: Tensor, constraint: Tensor, thresholds: Tensor, min_constraint: float
) -> Tuple[Tensor, Tensor]:
    """``_lexargmax`` over ``(primary, constraint, threshold)`` points meeting
    ``constraint >= min_constraint``, along the last axis (leading axes are
    independent rows: classes or labels).

    No point meets the constraint: ``(0, 1e6)``. A best primary of 0 reports
    the threshold ``1e6``. Both are float32. No host sync.
    """
    primary, constraint, thresholds, valid = _constrained_rows(primary, constraint, thresholds, min_constraint)
    p = torch.where(valid, primary, float("-inf"))
    m1 = valid & (p == p.amax(-1, keepdim=True))
    c = torch.where(m1, constraint, float("-inf"))
    m2 = m1 & (c == c.amax(-1, keepdim=True))
    idx = torch.argmax(torch.where(m2, thresholds, float("-inf")), dim=-1, keepdim=True)
    has = valid.any(-1)
    best = torch.where(has, primary.gather(-1, idx).squeeze(-1), 0.0).to(torch.float32)
    best_threshold = torch.where(has & (best != 0.0), thresholds.gather(-1, idx).squeeze(-1), 1e6).to(torch.float32)
    return best, best_threshold


def _recall_at_precision(precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float) -> Tuple[Tensor, Tensor]:
    """Max recall whose precision >= min_precision, on the device."""
    return _lex_best_at_constraint_device(recall, precision, thresholds, min_precision)


def _select_per_curve(curves, select: Callable[[Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]) -> Tuple[Tensor, Tensor]:
    """``select`` over per-class curves: one call on the stacked binned curves
    (classes as rows), or one per class of the exact curves' lists, stacked."""
    first, second, thresholds = curves
    if isinstance(first, Tensor):
        return select(first, second, thresholds)
    res = [select(a, b, t) for a, b, t in zip(first, second, thresholds)]
    return torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res])


def _check_min_value(name: str, value: float) -> None:
    if not isinstance(value, float) or not (0 <= value <= 1):
        raise ValueError(f"Expected argument `{name}` to be an float in the [0,1] range, but got {value}")


def _binary_recall_at_fixed_precision_arg_validation(
    min_precision: float, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _check_min_value("min_precision", min_precision)


def _binary_recall_at_fixed_precision_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    min_precision: float,
    pos_label: int = 1,
    reduce_fn: Selection = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    """Curve -> (max recall, threshold)."""
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return reduce_fn(precision, recall, thresholds, min_precision)


def _binary_curve_point(preds, target, thresholds, ignore_index, validate_args, validate: Callable, compute: Callable):
    """The binary functional of a fixed-point family: ``validate()`` the
    arguments, fold the batch into the PR-curve state (K1 for a grid) and
    return ``compute(state, thresholds)``."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        validate()
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    return compute(_binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine), thresholds)


def _multiclass_curve_point(preds, target, num_classes, thresholds, ignore_index, validate_args, validate, compute):
    """:func:`_binary_curve_point` for multiclass scores (K1's labels mode)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        validate()
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds, ignore_index)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, None, ascending, affine)
    return compute(state, thresholds)


def _multilabel_curve_point(preds, target, num_labels, thresholds, ignore_index, validate_args, validate, compute):
    """:func:`_binary_curve_point` for multilabel scores (K1's matrix mode)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        validate()
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds, ignore_index)
    return compute(_multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ascending, affine), thresholds)


def binary_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    min_precision: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest recall at minimum precision, binary."""
    return _binary_curve_point(
        preds, target, thresholds, ignore_index, validate_args,
        lambda: _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index),
        lambda state, thr: _binary_recall_at_fixed_precision_compute(state, thr, min_precision),
    )


def _multiclass_recall_at_fixed_precision_arg_validation(
    num_classes: int, min_precision: float, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _check_min_value("min_precision", min_precision)


def _multiclass_recall_at_fixed_precision_arg_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    min_precision: float,
    reduce_fn: Selection = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    """Per-class curves -> per-class (recall, threshold)."""
    curves = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _select_per_curve(curves, lambda p, r, t: reduce_fn(p, r, t, min_precision))


def multiclass_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest recall at minimum precision, multiclass."""
    return _multiclass_curve_point(
        preds, target, num_classes, thresholds, ignore_index, validate_args,
        lambda: _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index),
        lambda state, thr: _multiclass_recall_at_fixed_precision_arg_compute(state, num_classes, thr, min_precision),
    )


def _multilabel_recall_at_fixed_precision_arg_validation(
    num_labels: int, min_precision: float, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _check_min_value("min_precision", min_precision)


def _multilabel_recall_at_fixed_precision_arg_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_precision: float,
    reduce_fn: Selection = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    """Per-label curves -> per-label (recall, threshold)."""
    curves = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _select_per_curve(curves, lambda p, r, t: reduce_fn(p, r, t, min_precision))


def multilabel_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest recall at minimum precision, multilabel."""
    return _multilabel_curve_point(
        preds, target, num_labels, thresholds, ignore_index, validate_args,
        lambda: _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index),
        lambda state, thr: _multilabel_recall_at_fixed_precision_arg_compute(state, num_labels, thr, ignore_index, min_precision),
    )


def recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_precision: float,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching recall at fixed precision."""
    return _literal_task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_recall_at_fixed_precision(preds, target, min_precision, thresholds, ignore_index, validate_args),
        lambda: multiclass_recall_at_fixed_precision(
            preds, target, num_classes, min_precision, thresholds, ignore_index, validate_args
        ),
        lambda: multilabel_recall_at_fixed_precision(
            preds, target, num_labels, min_precision, thresholds, ignore_index, validate_args
        ),
    )
