# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional classification metrics of the port: binary, multiclass and multilabel; binned and exact curves,
the stat-scores families and the confusion-matrix families."""
from torchmetrics_tpu_torch.functional.classification.accuracy import (
    accuracy,
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from torchmetrics_tpu_torch.functional.classification.auroc import (
    auroc,
    binary_auroc,
    multiclass_auroc,
    multilabel_auroc,
)
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import (
    binary_cohen_kappa,
    cohen_kappa,
    multiclass_cohen_kappa,
)
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from torchmetrics_tpu_torch.functional.classification.exact_match import (
    exact_match,
    multiclass_exact_match,
    multilabel_exact_match,
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
from torchmetrics_tpu_torch.functional.classification.hamming import (
    binary_hamming_distance,
    hamming_distance,
    multiclass_hamming_distance,
    multilabel_hamming_distance,
)
from torchmetrics_tpu_torch.functional.classification.jaccard import (
    binary_jaccard_index,
    jaccard_index,
    multiclass_jaccard_index,
    multilabel_jaccard_index,
)
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import (
    binary_matthews_corrcoef,
    matthews_corrcoef,
    multiclass_matthews_corrcoef,
    multilabel_matthews_corrcoef,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall import (
    binary_negative_predictive_value,
    binary_precision,
    binary_recall,
    multiclass_negative_predictive_value,
    multiclass_precision,
    multiclass_recall,
    multilabel_negative_predictive_value,
    multilabel_precision,
    multilabel_recall,
    negative_predictive_value,
    precision,
    recall,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from torchmetrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc, roc
from torchmetrics_tpu_torch.functional.classification.specificity import (
    binary_specificity,
    multiclass_specificity,
    multilabel_specificity,
    specificity,
)
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
    "binary_cohen_kappa",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_hamming_distance",
    "binary_jaccard_index",
    "binary_matthews_corrcoef",
    "binary_negative_predictive_value",
    "binary_precision",
    "binary_precision_recall_curve",
    "binary_recall",
    "binary_roc",
    "binary_specificity",
    "binary_stat_scores",
    "cohen_kappa",
    "confusion_matrix",
    "exact_match",
    "f1_score",
    "fbeta_score",
    "hamming_distance",
    "jaccard_index",
    "matthews_corrcoef",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_cohen_kappa",
    "multiclass_confusion_matrix",
    "multiclass_exact_match",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_hamming_distance",
    "multiclass_jaccard_index",
    "multiclass_matthews_corrcoef",
    "multiclass_negative_predictive_value",
    "multiclass_precision",
    "multiclass_precision_recall_curve",
    "multiclass_recall",
    "multiclass_roc",
    "multiclass_specificity",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_confusion_matrix",
    "multilabel_exact_match",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_hamming_distance",
    "multilabel_jaccard_index",
    "multilabel_matthews_corrcoef",
    "multilabel_negative_predictive_value",
    "multilabel_precision",
    "multilabel_precision_recall_curve",
    "multilabel_recall",
    "multilabel_roc",
    "multilabel_specificity",
    "multilabel_stat_scores",
    "negative_predictive_value",
    "precision",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
