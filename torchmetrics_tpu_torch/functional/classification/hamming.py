# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Hamming distance (counterpart of ``torchmetrics_tpu/functional/classification/hamming.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.classification._family import (
    make_binary,
    make_multiclass,
    make_multilabel,
    make_task_dispatch,
)
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _dim_sum, _safe_divide

Tensor = torch.Tensor


def _hamming_distance_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    """One minus an accuracy-style score: ``(tp + tn) / all`` for binary and
    multilabel entries, ``tp / (tp + fn)`` for multiclass ones."""
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp, fn = _dim_sum(tp, axis), _dim_sum(fn, axis)
        if multilabel:
            fp, tn = _dim_sum(fp, axis), _dim_sum(tn, axis)
            return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
        return 1 - _safe_divide(tp, tp + fn)
    score = 1 - _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else 1 - _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


binary_hamming_distance = make_binary(_hamming_distance_reduce, "hamming_distance")
multiclass_hamming_distance = make_multiclass(_hamming_distance_reduce, "hamming_distance")
multilabel_hamming_distance = make_multilabel(_hamming_distance_reduce, "hamming_distance")
hamming_distance = make_task_dispatch(
    "hamming_distance", binary_hamming_distance, multiclass_hamming_distance, multilabel_hamming_distance
)
