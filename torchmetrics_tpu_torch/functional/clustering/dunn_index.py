# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Dunn index (counterpart of ``torchmetrics_tpu/functional/clustering/dunn_index.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import _cluster_stats
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def _dunn_index_update(data: Tensor, labels: Tensor, p: float) -> Tuple[Tensor, Tensor]:
    """Inter-centroid distances (upper triangle) and each cluster's largest distance to its centroid.

    JAX's formula: the ``(K, K, d)`` centroid difference (8.2 GB at 1,000
    clusters of 2,048 features) and, per cluster, the max over its samples,
    taken here by ``scatter_reduce("amax")`` in place of JAX's ``(N, K)``
    masked max: a max is exact, so the values are the same.
    """
    data = data.to(torch.float32)
    inverse, counts, centroids = _cluster_stats(data, labels)
    num_labels = counts.shape[0]

    diff = centroids[:, None, :] - centroids[None, :, :]  # (K, K, d)
    dist = torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
    del diff
    iu = torch.triu_indices(num_labels, num_labels, offset=1, device=data.device)
    intercluster_distance = dist[iu[0], iu[1]]

    sample_dist = torch.sum(torch.abs(data - centroids[inverse]) ** p, dim=-1) ** (1.0 / p)
    lowest = torch.full((num_labels,), float("-inf"), dtype=sample_dist.dtype, device=data.device)
    max_intracluster_distance = lowest.scatter_reduce(0, inverse, sample_dist, "amax")
    return intercluster_distance, max_intracluster_distance


def _dunn_index_compute(intercluster_distance: Tensor, max_intracluster_distance: Tensor) -> Tensor:
    """min inter / max intra."""
    return intercluster_distance.min() / max_intracluster_distance.max()


def dunn_index(data: Tensor, labels: Tensor, p: float = 2) -> Tensor:
    """Dunn index of a clustering of embedded data."""
    data, labels = map(_jnp_dtype, _to_tensors(data, labels))
    pairwise_distance, max_distance = _dunn_index_update(data, labels, p)
    return _dunn_index_compute(pairwise_distance, max_distance)
