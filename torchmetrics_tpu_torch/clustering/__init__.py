# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Clustering module metrics (counterpart of ``torchmetrics_tpu/clustering/``)."""
from torchmetrics_tpu_torch.clustering.metrics import (
    AdjustedMutualInfoScore,
    AdjustedRandScore,
    CalinskiHarabaszScore,
    CompletenessScore,
    DaviesBouldinScore,
    DunnIndex,
    FowlkesMallowsIndex,
    HomogeneityScore,
    MutualInfoScore,
    NormalizedMutualInfoScore,
    RandScore,
    VMeasureScore,
)

__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "DunnIndex",
    "FowlkesMallowsIndex",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]
