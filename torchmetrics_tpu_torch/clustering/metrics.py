# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Clustering module metrics (counterpart of ``torchmetrics_tpu/clustering/metrics.py``).

Two state machines, with the JAX package's state names:

- the extrinsic (label against label) metrics keep ``preds`` and
  ``target`` as ``cat`` list states and evaluate the functional metric on
  the concatenated stream at ``compute`` (cluster ids are arbitrary, so
  per-batch contingency matrices cannot be merged);
- the intrinsic (data against label) metrics keep ``data`` and ``labels``
  the same way.

Each batch is kept in the dtype ``jnp.asarray`` gives it (float64 as
float32, int64 as int32), so the state trees cross between the packages.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from torchmetrics_tpu_torch.functional.clustering import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    calinski_harabasz_score,
    completeness_score,
    davies_bouldin_score,
    dunn_index,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.utils import _validate_average_method_arg
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, dim_zero_cat

Tensor = torch.Tensor


class _LabelPairClusteringMetric(Metric):
    """The cat-state machine of the extrinsic clustering metrics."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append predicted and target cluster labels."""
        preds, target = self._inputs(preds, target)
        self.preds.append(_jnp_dtype(preds))
        self.target.append(_jnp_dtype(target))

    def _compute(self, fn: Callable, *args: Any) -> Tensor:
        return fn(dim_zero_cat(self.preds), dim_zero_cat(self.target), *args)


class MutualInfoScore(_LabelPairClusteringMetric):
    """Mutual information score."""

    def compute(self) -> Tensor:
        return self._compute(mutual_info_score)


class AdjustedMutualInfoScore(_LabelPairClusteringMetric):
    """Adjusted mutual info score."""

    plot_lower_bound = -1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def compute(self) -> Tensor:
        return self._compute(adjusted_mutual_info_score, self.average_method)


class NormalizedMutualInfoScore(_LabelPairClusteringMetric):
    """Normalized mutual info score."""

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def compute(self) -> Tensor:
        return self._compute(normalized_mutual_info_score, self.average_method)


class RandScore(_LabelPairClusteringMetric):
    """Rand score."""

    def compute(self) -> Tensor:
        return self._compute(rand_score)


class AdjustedRandScore(_LabelPairClusteringMetric):
    """Adjusted Rand score."""

    plot_lower_bound = -0.5

    def compute(self) -> Tensor:
        return self._compute(adjusted_rand_score)


class FowlkesMallowsIndex(_LabelPairClusteringMetric):
    """Fowlkes-Mallows index."""

    def compute(self) -> Tensor:
        return self._compute(fowlkes_mallows_index)


class HomogeneityScore(_LabelPairClusteringMetric):
    """Homogeneity score."""

    def compute(self) -> Tensor:
        return self._compute(homogeneity_score)


class CompletenessScore(_LabelPairClusteringMetric):
    """Completeness score."""

    def compute(self) -> Tensor:
        return self._compute(completeness_score)


class VMeasureScore(_LabelPairClusteringMetric):
    """V-measure score."""

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, float) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = beta

    def compute(self) -> Tensor:
        return self._compute(v_measure_score, self.beta)


class _IntrinsicClusteringMetric(Metric):
    """The cat-state machine of the intrinsic (embedded-data) metrics."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")

    def update(self, data: Tensor, labels: Tensor) -> None:
        """Append embedded data and their cluster labels."""
        data, labels = self._inputs(data, labels)
        self.data.append(_jnp_dtype(data))
        self.labels.append(_jnp_dtype(labels))


class CalinskiHarabaszScore(_IntrinsicClusteringMetric):
    """Calinski-Harabasz score."""

    def compute(self) -> Tensor:
        return calinski_harabasz_score(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class DaviesBouldinScore(_IntrinsicClusteringMetric):
    """Davies-Bouldin score."""

    higher_is_better = False

    def compute(self) -> Tensor:
        return davies_bouldin_score(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class DunnIndex(_IntrinsicClusteringMetric):
    """Dunn index."""

    def __init__(self, p: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def compute(self) -> Tensor:
        return dunn_index(dim_zero_cat(self.data), dim_zero_cat(self.labels), self.p)
