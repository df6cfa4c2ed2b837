# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional clustering metrics (counterpart of ``torchmetrics_tpu/functional/clustering/__init__.py``)."""
from torchmetrics_tpu_torch.functional.clustering.adjusted_mutual_info_score import adjusted_mutual_info_score
from torchmetrics_tpu_torch.functional.clustering.adjusted_rand_score import adjusted_rand_score
from torchmetrics_tpu_torch.functional.clustering.calinski_harabasz_score import calinski_harabasz_score
from torchmetrics_tpu_torch.functional.clustering.davies_bouldin_score import davies_bouldin_score
from torchmetrics_tpu_torch.functional.clustering.dunn_index import dunn_index
from torchmetrics_tpu_torch.functional.clustering.fowlkes_mallows_index import fowlkes_mallows_index
from torchmetrics_tpu_torch.functional.clustering.homogeneity_completeness_v_measure import (
    completeness_score,
    homogeneity_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.mutual_info_score import mutual_info_score
from torchmetrics_tpu_torch.functional.clustering.normalized_mutual_info_score import normalized_mutual_info_score
from torchmetrics_tpu_torch.functional.clustering.rand_score import rand_score

__all__ = [
    "adjusted_mutual_info_score",
    "adjusted_rand_score",
    "calinski_harabasz_score",
    "completeness_score",
    "davies_bouldin_score",
    "dunn_index",
    "fowlkes_mallows_index",
    "homogeneity_score",
    "mutual_info_score",
    "normalized_mutual_info_score",
    "rand_score",
    "v_measure_score",
]
