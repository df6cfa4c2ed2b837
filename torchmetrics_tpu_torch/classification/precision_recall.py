# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Precision, recall and negative predictive value module metrics (counterpart
of ``torchmetrics_tpu/classification/precision_recall.py``)."""
from __future__ import annotations

from torchmetrics_tpu_torch.classification._derived import make_stat_scores_family
from torchmetrics_tpu_torch.functional.classification.precision_recall import _npv_reduce, _precision_reduce, _recall_reduce

BinaryPrecision, MulticlassPrecision, MultilabelPrecision, Precision = make_stat_scores_family("Precision", _precision_reduce)
BinaryRecall, MulticlassRecall, MultilabelRecall, Recall = make_stat_scores_family("Recall", _recall_reduce)
(
    BinaryNegativePredictiveValue,
    MulticlassNegativePredictiveValue,
    MultilabelNegativePredictiveValue,
    NegativePredictiveValue,
) = make_stat_scores_family("NegativePredictiveValue", _npv_reduce)

__all__ = [
    "BinaryPrecision",
    "MulticlassPrecision",
    "MultilabelPrecision",
    "Precision",
    "BinaryRecall",
    "MulticlassRecall",
    "MultilabelRecall",
    "Recall",
    "BinaryNegativePredictiveValue",
    "MulticlassNegativePredictiveValue",
    "MultilabelNegativePredictiveValue",
    "NegativePredictiveValue",
]
