# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Factory for stat-scores-derived functional families (counterpart of
``torchmetrics_tpu/functional/classification/_family.py``).

One factory builds the ``binary_*``/``multiclass_*``/``multilabel_*``
functions and the task dispatcher of a family from its reduce function, over
the ported stat scores: the multiclass counts run in the hand kernel K2
where ``average != "micro"``, ``top_k == 1`` and ``multidim_average ==
"global"`` (see ``stat_scores.py``).

A reduce function has the signature
``reduce(tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division)``.
"""
from __future__ import annotations

from typing import Callable, Optional

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
from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


def _named(fn: Callable, name: str) -> Callable:
    fn.__name__ = fn.__qualname__ = name
    return fn


def make_binary(reduce: Callable, name: str) -> Callable:
    def binary_fn(
        preds: Tensor,
        target: Tensor,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ) -> Tensor:
        preds, target = _to_tensors(preds, target)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index, zero_division)
            _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
        preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
        tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
        return reduce(tp, fp, tn, fn, "binary", multidim_average, False, 1, zero_division)

    return _named(binary_fn, f"binary_{name}")


def make_multiclass(reduce: Callable, name: str, default_average: str = "macro") -> Callable:
    def multiclass_fn(
        preds: Tensor,
        target: Tensor,
        num_classes: int,
        average: Optional[str] = default_average,
        top_k: int = 1,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ) -> Tensor:
        preds, target = _to_tensors(preds, target)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index, zero_division)
            _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
        preds, target = _multiclass_stat_scores_format(preds, target, top_k, average, multidim_average)
        tp, fp, tn, fn = _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)
        return reduce(tp, fp, tn, fn, average, multidim_average, False, top_k, zero_division)

    return _named(multiclass_fn, f"multiclass_{name}")


def make_multilabel(reduce: Callable, name: str, default_average: str = "macro") -> Callable:
    def multilabel_fn(
        preds: Tensor,
        target: Tensor,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = default_average,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ) -> Tensor:
        preds, target = _to_tensors(preds, target)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index, zero_division)
            _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
        preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
        tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
        return reduce(tp, fp, tn, fn, average, multidim_average, True, 1, zero_division)

    return _named(multilabel_fn, f"multilabel_{name}")


def make_task_dispatch(name: str, binary_fn: Callable, multiclass_fn: Callable, multilabel_fn: Callable) -> Callable:
    def task_fn(
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
        def multiclass() -> Tensor:
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
            return multiclass_fn(
                preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
            )

        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: binary_fn(preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division),
            multiclass,
            lambda: multilabel_fn(
                preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
            ),
        )

    return _named(task_fn, name)
