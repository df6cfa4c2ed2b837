# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Accuracy module metrics (counterpart of ``torchmetrics_tpu/classification/accuracy.py``)."""
from __future__ import annotations

from torchmetrics_tpu_torch.classification._derived import make_stat_scores_family
from torchmetrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce


def _reduce(tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division):
    return _accuracy_reduce(tp, fp, tn, fn, average, multidim_average, multilabel, top_k)


BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy, Accuracy = make_stat_scores_family("Accuracy", _reduce)

__all__ = ["BinaryAccuracy", "MulticlassAccuracy", "MultilabelAccuracy", "Accuracy"]
