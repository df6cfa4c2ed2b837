# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Hamming distance module metrics (counterpart of ``torchmetrics_tpu/classification/hamming.py``)."""
from __future__ import annotations

from torchmetrics_tpu_torch.classification._derived import make_stat_scores_family
from torchmetrics_tpu_torch.functional.classification.hamming import _hamming_distance_reduce

BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance, HammingDistance = make_stat_scores_family(
    "HammingDistance", _hamming_distance_reduce, higher_is_better=False
)

__all__ = ["BinaryHammingDistance", "MulticlassHammingDistance", "MultilabelHammingDistance", "HammingDistance"]
