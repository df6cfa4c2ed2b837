# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional classification metrics of the port: binary, multiclass and multilabel; binned and exact curves."""
from torchmetrics_tpu_torch.functional.classification.accuracy import (
    accuracy,
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from torchmetrics_tpu_torch.functional.classification.auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from torchmetrics_tpu_torch.functional.classification.f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    f1_score,
    fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from torchmetrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc, roc
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
    stat_scores,
)

__all__ = [
    "accuracy",
    "auroc",
    "average_precision",
    "binary_accuracy",
    "binary_auroc",
    "binary_average_precision",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_precision_recall_curve",
    "binary_roc",
    "binary_stat_scores",
    "f1_score",
    "fbeta_score",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_roc",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_precision_recall_curve",
    "multilabel_roc",
    "multilabel_stat_scores",
    "precision_recall_curve",
    "roc",
    "stat_scores",
]
