# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Precision, recall and negative predictive value (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification._family import (
    make_binary,
    make_multiclass,
    make_multilabel,
    make_task_dispatch,
)
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _dim_sum, _safe_divide

Tensor = torch.Tensor


def _precision_recall_reduce_impl(
    stat: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0,
) -> Tensor:
    """Reduce stats into precision (``tp / (tp + fp)``) or recall (``tp / (tp + fn)``)."""
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp, fp, fn = _dim_sum(tp, axis), _dim_sum(fp, axis), _dim_sum(fn, axis)
    different_stat = fp if stat == "precision" else fn
    score = _safe_divide(tp, tp + different_stat, zero_division)
    if average in ("binary", "micro"):
        return score
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def _precision_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    return _precision_recall_reduce_impl("precision", tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division)


def _recall_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    return _precision_recall_reduce_impl("recall", tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division)


binary_precision = make_binary(_precision_reduce, "precision")
multiclass_precision = make_multiclass(_precision_reduce, "precision")
multilabel_precision = make_multilabel(_precision_reduce, "precision")
precision = make_task_dispatch("precision", binary_precision, multiclass_precision, multilabel_precision)

binary_recall = make_binary(_recall_reduce, "recall")
multiclass_recall = make_multiclass(_recall_reduce, "recall")
multilabel_recall = make_multilabel(_recall_reduce, "recall")
recall = make_task_dispatch("recall", binary_recall, multiclass_recall, multilabel_recall)


def _npv_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    """Negative predictive value, ``tn / (tn + fn)``."""
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        return _safe_divide(_dim_sum(tn, axis), _dim_sum(tn, axis) + _dim_sum(fn, axis), zero_division)
    score = _safe_divide(tn, tn + fn, zero_division)
    if average == "binary":
        return score
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


binary_negative_predictive_value = make_binary(_npv_reduce, "negative_predictive_value")
multiclass_negative_predictive_value = make_multiclass(_npv_reduce, "negative_predictive_value")
multilabel_negative_predictive_value = make_multilabel(_npv_reduce, "negative_predictive_value")
negative_predictive_value = make_task_dispatch(
    "negative_predictive_value",
    binary_negative_predictive_value,
    multiclass_negative_predictive_value,
    multilabel_negative_predictive_value,
)
