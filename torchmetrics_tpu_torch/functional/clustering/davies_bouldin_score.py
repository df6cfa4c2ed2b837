# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Davies-Bouldin score (counterpart of ``torchmetrics_tpu/functional/clustering/davies_bouldin_score.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _cluster_stats,
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def davies_bouldin_score(data: Tensor, labels: Tensor) -> Tensor:
    """Mean worst-case intra/inter cluster distance ratio; 0 for a degenerate clustering.

    The centroid distances keep JAX's ``(K, K, d)`` difference (8.2 GB at
    1,000 clusters of 2,048 features). Whether every intra or every inter
    distance is about 0 is ``torch.allclose`` with ``jnp.allclose``'s
    ``rtol=1e-5, atol=1e-8``, a host read.
    """
    data, labels = map(_jnp_dtype, _to_tensors(data, labels))
    _validate_intrinsic_cluster_data(data, labels)
    inverse, counts, centroids = _cluster_stats(data, labels)
    num_labels = counts.shape[0]
    num_samples = data.shape[0]
    _validate_intrinsic_labels_to_samples(num_labels, num_samples)

    # per-cluster mean distance to the centroid by a one-hot segment mean
    dists = torch.sqrt(((data - centroids[inverse]) ** 2).sum(dim=1))
    onehot = torch.nn.functional.one_hot(inverse, num_labels).to(data.dtype)
    intra_dists = (onehot.T @ dists) / counts

    diff = centroids[:, None, :] - centroids[None, :, :]
    centroid_distances = torch.sqrt((diff**2).sum(dim=-1))
    del diff

    degenerate = torch.allclose(intra_dists, torch.zeros_like(intra_dists), rtol=1e-5, atol=1e-8) or torch.allclose(
        centroid_distances, torch.zeros_like(centroid_distances), rtol=1e-5, atol=1e-8
    )
    centroid_distances = torch.where(
        centroid_distances == 0, torch.full_like(centroid_distances, float("inf")), centroid_distances
    )
    combined_intra = intra_dists[None, :] + intra_dists[:, None]
    scores = (combined_intra / centroid_distances).max(dim=1).values
    return torch.zeros_like(scores[0]) if degenerate else scores.mean()
