# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Rand score (counterpart of ``torchmetrics_tpu/functional/clustering/rand_score.py``)."""
from __future__ import annotations

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def _rand_score_update(preds: Tensor, target: Tensor) -> Tensor:
    """The int32 contingency matrix."""
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(preds, target)


def _rand_score_compute(contingency: Tensor) -> Tensor:
    """Rand score from the pair confusion matrix (host float64, then float32)."""
    pair_matrix = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    numerator = np.diagonal(pair_matrix).sum()
    denominator = pair_matrix.sum()
    if numerator == denominator or denominator == 0:
        # trivial clusterings are perfect matches
        return torch.tensor(1.0, device=contingency.device)
    return torch.tensor(numerator / denominator, dtype=torch.float32, device=contingency.device)


def rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Rand score between two clusterings."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    contingency = _rand_score_update(preds, target)
    return _rand_score_compute(contingency)
