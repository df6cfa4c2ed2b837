# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Calinski-Harabasz score (counterpart of ``torchmetrics_tpu/functional/clustering/calinski_harabasz_score.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _cluster_stats,
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def calinski_harabasz_score(data: Tensor, labels: Tensor) -> Tensor:
    """Between- vs within-cluster dispersion ratio; 1 where the within-dispersion is 0."""
    data, labels = map(_jnp_dtype, _to_tensors(data, labels))
    _validate_intrinsic_cluster_data(data, labels)
    inverse, counts, centroids = _cluster_stats(data, labels)
    num_labels = counts.shape[0]
    num_samples = data.shape[0]
    _validate_intrinsic_labels_to_samples(num_labels, num_samples)

    mean = data.mean(dim=0)
    between = (counts * ((centroids - mean[None, :]) ** 2).sum(dim=1)).sum()
    within = ((data - centroids[inverse]) ** 2).sum()
    one = torch.ones_like(within)
    safe_within = torch.where(within == 0, one, within)
    score = between * (num_samples - num_labels) / (safe_within * (num_labels - 1.0))
    return torch.where(within == 0, one, score)
