# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional regression metrics of the port (counterpart of
``torchmetrics_tpu/functional/regression/__init__.py``)."""
from torchmetrics_tpu_torch.functional.regression.concordance import concordance_corrcoef
from torchmetrics_tpu_torch.functional.regression.cosine_similarity import cosine_similarity
from torchmetrics_tpu_torch.functional.regression.csi import critical_success_index
from torchmetrics_tpu_torch.functional.regression.explained_variance import explained_variance
from torchmetrics_tpu_torch.functional.regression.kendall import kendall_rank_corrcoef
from torchmetrics_tpu_torch.functional.regression.kl_divergence import kl_divergence
from torchmetrics_tpu_torch.functional.regression.log_cosh import log_cosh_error
from torchmetrics_tpu_torch.functional.regression.log_mse import mean_squared_log_error
from torchmetrics_tpu_torch.functional.regression.mae import mean_absolute_error
from torchmetrics_tpu_torch.functional.regression.mape import mean_absolute_percentage_error
from torchmetrics_tpu_torch.functional.regression.minkowski import minkowski_distance
from torchmetrics_tpu_torch.functional.regression.mse import mean_squared_error
from torchmetrics_tpu_torch.functional.regression.pearson import pearson_corrcoef
from torchmetrics_tpu_torch.functional.regression.r2 import r2_score
from torchmetrics_tpu_torch.functional.regression.rse import relative_squared_error
from torchmetrics_tpu_torch.functional.regression.spearman import spearman_corrcoef
from torchmetrics_tpu_torch.functional.regression.symmetric_mape import symmetric_mean_absolute_percentage_error
from torchmetrics_tpu_torch.functional.regression.tweedie_deviance import tweedie_deviance_score
from torchmetrics_tpu_torch.functional.regression.wmape import weighted_mean_absolute_percentage_error

__all__ = [
    "concordance_corrcoef",
    "cosine_similarity",
    "critical_success_index",
    "explained_variance",
    "kendall_rank_corrcoef",
    "kl_divergence",
    "log_cosh_error",
    "mean_squared_log_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "minkowski_distance",
    "mean_squared_error",
    "pearson_corrcoef",
    "r2_score",
    "relative_squared_error",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
