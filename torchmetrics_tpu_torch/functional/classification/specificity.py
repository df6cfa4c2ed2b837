# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Specificity (counterpart of ``torchmetrics_tpu/functional/classification/specificity.py``)."""
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


def _specificity_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    """``tn / (tn + fp)``."""
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        return _safe_divide(_dim_sum(tn, axis), _dim_sum(tn, axis) + _dim_sum(fp, axis), zero_division)
    score = _safe_divide(tn, tn + fp, zero_division)
    if average == "binary":
        return score
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


binary_specificity = make_binary(_specificity_reduce, "specificity")
multiclass_specificity = make_multiclass(_specificity_reduce, "specificity")
multilabel_specificity = make_multilabel(_specificity_reduce, "specificity")
specificity = make_task_dispatch("specificity", binary_specificity, multiclass_specificity, multilabel_specificity)
