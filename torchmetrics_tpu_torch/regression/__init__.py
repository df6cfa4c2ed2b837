# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Regression module metrics of the port (counterpart of
``torchmetrics_tpu/regression/__init__.py``)."""
from torchmetrics_tpu_torch.regression.concordance import ConcordanceCorrCoef
from torchmetrics_tpu_torch.regression.cosine_similarity import CosineSimilarity
from torchmetrics_tpu_torch.regression.csi import CriticalSuccessIndex
from torchmetrics_tpu_torch.regression.explained_variance import ExplainedVariance
from torchmetrics_tpu_torch.regression.kendall import KendallRankCorrCoef
from torchmetrics_tpu_torch.regression.kl_divergence import KLDivergence
from torchmetrics_tpu_torch.regression.log_cosh import LogCoshError
from torchmetrics_tpu_torch.regression.log_mse import MeanSquaredLogError
from torchmetrics_tpu_torch.regression.mae import MeanAbsoluteError
from torchmetrics_tpu_torch.regression.mape import MeanAbsolutePercentageError
from torchmetrics_tpu_torch.regression.minkowski import MinkowskiDistance
from torchmetrics_tpu_torch.regression.mse import MeanSquaredError
from torchmetrics_tpu_torch.regression.pearson import PearsonCorrCoef
from torchmetrics_tpu_torch.regression.r2 import R2Score
from torchmetrics_tpu_torch.regression.rse import RelativeSquaredError
from torchmetrics_tpu_torch.regression.spearman import SpearmanCorrCoef
from torchmetrics_tpu_torch.regression.symmetric_mape import SymmetricMeanAbsolutePercentageError
from torchmetrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore
from torchmetrics_tpu_torch.regression.wmape import WeightedMeanAbsolutePercentageError

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "CriticalSuccessIndex",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanSquaredLogError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MinkowskiDistance",
    "MeanSquaredError",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
