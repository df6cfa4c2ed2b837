# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Classification module metrics of the port: binary, multiclass and multilabel; binned and exact curves."""
from torchmetrics_tpu_torch.classification.accuracy import (
    Accuracy,
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
)
from torchmetrics_tpu_torch.classification.auroc import (
    AUROC,
    BinaryAUROC,
    MulticlassAUROC,
    MultilabelAUROC,
)
from torchmetrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from torchmetrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.roc import (
    BinaryROC,
    MulticlassROC,
    MultilabelROC,
    ROC,
)
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinaryAUROC",
    "BinaryAccuracy",
    "BinaryAveragePrecision",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryPrecisionRecallCurve",
    "BinaryROC",
    "BinaryStatScores",
    "F1Score",
    "FBetaScore",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassROC",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAccuracy",
    "MultilabelAveragePrecision",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelPrecisionRecallCurve",
    "MultilabelROC",
    "MultilabelStatScores",
    "PrecisionRecallCurve",
    "ROC",
    "StatScores",
]
