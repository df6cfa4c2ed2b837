# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The PyTorch/CUDA port of ``torchmetrics_tpu`` (counterpart package).

It mirrors the JAX package's module paths and names and imports neither JAX
nor anything of ``torchmetrics_tpu``. Module metrics run on ``device="cuda"``
unless given another device; the hot loops run in kernels written by hand
for Hopper (``torchmetrics_tpu_torch.ops``), each beside its plain PyTorch
version, which CPU tensors use. See ROADMAP.md for what is ported so far.
"""
from torchmetrics_tpu_torch.classification import (
    AUROC,
    Accuracy,
    AveragePrecision,
    BinaryAUROC,
    BinaryAccuracy,
    BinaryAveragePrecision,
    BinaryF1Score,
    BinaryFBetaScore,
    BinaryPrecisionRecallCurve,
    BinaryROC,
    BinaryStatScores,
    F1Score,
    FBetaScore,
    MulticlassAUROC,
    MulticlassAccuracy,
    MulticlassAveragePrecision,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MulticlassPrecisionRecallCurve,
    MulticlassROC,
    MulticlassStatScores,
    MultilabelAUROC,
    MultilabelAccuracy,
    MultilabelAveragePrecision,
    MultilabelF1Score,
    MultilabelFBetaScore,
    MultilabelPrecisionRecallCurve,
    MultilabelROC,
    MultilabelStatScores,
    PrecisionRecallCurve,
    ROC,
    StatScores,
)
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.robustness import SyncConfig

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
    "Metric",
    "MetricCollection",
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
    "SyncConfig",
]
