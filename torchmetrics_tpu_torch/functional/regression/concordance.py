# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Concordance correlation coefficient (counterpart of
``torchmetrics_tpu/functional/regression/concordance.py``); it rides the
Pearson statistics."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.regression.pearson import (
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
    _zero_statistics,
)
from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair

Tensor = torch.Tensor


def _concordance_corrcoef_compute(
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    nb: Tensor,
) -> Tensor:
    """CCC from the Pearson statistics."""
    pearson = _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    return 2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y) / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the concordance correlation coefficient."""
    preds, target = _float32_pair(preds, target)
    d = preds.shape[1] if preds.ndim == 2 else 1
    stats = _pearson_corrcoef_update(preds, target, *_zero_statistics(preds), num_outputs=d)
    return _concordance_corrcoef_compute(*stats)
