# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Adjusted Rand score (counterpart of ``torchmetrics_tpu/functional/clustering/adjusted_rand_score.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def _adjusted_rand_score_update(preds: Tensor, target: Tensor) -> Tensor:
    """The int32 contingency matrix."""
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(preds, target)


def _adjusted_rand_score_compute(contingency: Tensor) -> Tensor:
    """ARI from the pair confusion matrix (host float64, then float32)."""
    (tn, fp), (fn, tp) = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    if fn == 0 and fp == 0:
        return torch.tensor(1.0, device=contingency.device)
    value = 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))
    return torch.tensor(value, dtype=torch.float32, device=contingency.device)


def adjusted_rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Adjusted Rand score between two clusterings."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    contingency = _adjusted_rand_score_update(preds, target)
    return _adjusted_rand_score_compute(contingency)
